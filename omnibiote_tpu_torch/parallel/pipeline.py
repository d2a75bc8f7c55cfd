"""Pipeline parallelism (GPipe) over the 'stage' axis of a mesh.

Port of `omnibiote_tpu/parallel/pipeline.py`. Stage s of S holds the
blocks of the layers [s·L/S, (s+1)·L/S) (parallel/sharding.py: the JAX
package's `pp_param_pspecs`); every stage holds the embedding, ln_f and the
head, whose gradients the train step sums over 'stage'. One step runs the
A accumulation slots as micro-batches through the GPipe schedule, the JAX
package's `pp_mlm_loss`:

  * every stage draws each micro-batch's MLM mask and dropout seeds as the
    plain step does (`mlm_loss`): slot j's seed split into the mask's and
    the dropout's, the layer seeds drawn for all L layers and read at
    their global indices, so a stage draws what the whole model would;
  * forward: M + S − 1 ticks; at tick t stage s runs micro-batch t − s
    (stage 0 from the embedding, the others from what stage s − 1 sent)
    and hands its output to stage s + 1; each tick's send and receive go
    in one `batch_isend_irecv`, so every rank posts the same order;
  * readout: with A % S == 0 (head balance) the last stage broadcasts the
    final hidden states over 'stage' and stage s computes the CE of slots
    [s·A/S, (s+1)·A/S); else the last stage computes all of it. Each
    micro-batch's NLL sum is divided by its masked count summed over
    'data' (dp × pp), as the plain step divides by the global count;
  * backward: the readout's gradient, the hidden states' cotangents summed
    back to the last stage, then the ticks in reverse: stage s runs
    micro-batch t − s's backward from the cotangent stage s + 1 sent and
    sends its input's cotangent to stage s − 1, freeing that micro-batch's
    graph. The gradients accumulate in the compute copy's `.grad`, as the
    JAX step's one autodiff sums them;
  * slots with weight 0 (the batch ramp) are skipped: the JAX package
    computes them with weight 0, which adds nothing;
  * checkpoint_freq > 0: a stage's slice of layers runs under one
    `torch.utils.checkpoint` a micro-batch (remat_policy 'dots' saves the
    unbatched products, as `models/omnibiota.py` does); the masks are
    keyed per (layer, site), so the recompute draws the same ones.

The P2P runs on the default group with global peer ranks (a lost peer
fails at that group's timeout), the broadcast and reduce on the stage
axis's group.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import (checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..config import PAD_TOKEN
from ..models.omnibiota import (OmniBioTA, _dots_policy, _dropout, _forward_rngs,
                                _layer_norm)
from ..ops.flash_attention import SegmentBounds
from ..training.mlm import (_default_capacity_frac, apply_mlm_mask, make_mlm_mask,
                            masked_nll, split_seed)
from .sharding import stage_layers


class Stage:
    """A rank's place on the stage axis: its index, the stage count, the
    axis's group and the global ranks of its neighbours and of the last
    stage."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size
        ranks = dist.get_process_group_ranks(group) if group is not None else [0]
        self.prev = ranks[index - 1] if index > 0 else None
        self.next = ranks[index + 1] if index < size - 1 else None
        self.last_rank = ranks[-1]
        self.is_last = index == size - 1
        if size > 1:
            # a first collective on the default group (the schedule's P2P)
            # and on the stage group, joined by every rank: NCCL builds a
            # group's communicator at its first call
            probe = torch.zeros(1, device=("cuda" if dist.get_backend(group) == "nccl"
                                           else "cpu"))
            dist.all_reduce(probe)
            dist.all_reduce(probe, group=group)

    def layers(self, n_layer: int) -> range:
        """The global indices of this stage's layers."""
        return stage_layers(n_layer, self.size, self.index)


def micro_draws(model: OmniBioTA, tokens: torch.Tensor, seed: int, *, mask_prob: float,
                deterministic: bool, mask: Optional[torch.Tensor] = None,
                mask_rows: Optional[Tuple[int, int]] = None):
    """(MLM mask, embedding dropout seed, per-layer dropout seeds) of one
    micro-batch from its integer seed, as `mlm_loss` and the model's
    forward draw them (seeds None without dropout). mask: an explicit one;
    mask_rows: the tokens are those rows of the global micro-batch."""
    mask_seed, drop_seed = split_seed(seed)
    if mask is None:
        gen = torch.Generator(device=tokens.device)
        gen.manual_seed(mask_seed & 0x7FFFFFFFFFFFFFFF)
        mask = make_mlm_mask(gen, tokens, mask_prob, rows=mask_rows)
    if deterministic or model.cfg.dropout == 0.0:
        return mask, None, None
    emb_seed, layer_seeds = _forward_rngs(drop_seed, model.cfg.n_layer, model.data_index)
    return mask, emb_seed, layer_seeds


def embed(model: OmniBioTA, params: Mapping[str, torch.Tensor], ids: torch.Tensor,
          emb_seed: Optional[int] = None) -> torch.Tensor:
    """The first stage's input: the embedding of `ids` in the compute dtype,
    with its dropout when emb_seed is given (the model's forward)."""
    cfg = model.cfg
    x = F.embedding(ids.long(), params["transformer.wte.weight"]).to(cfg.cdtype())
    return _dropout(x, cfg.dropout, emb_seed)


def run_layers(model: OmniBioTA, params: Mapping[str, torch.Tensor], layers: Sequence[int],
               x: torch.Tensor, segment_ids: Optional[torch.Tensor], seg_bounds=None,
               layer_seeds=None, remat: bool = False) -> torch.Tensor:
    """Blocks `layers` (global indices, in order) of the model on x, from
    the tensors in `params` (global names); layer_seeds: all L layers'
    dropout seeds, or None. remat: the whole slice under one
    `torch.utils.checkpoint`, its parameters passed in as inputs."""
    cfg = model.cfg
    blocks = [model.transformer.h[i] for i in layers]
    names = [[n for n, _ in blk.named_parameters()] for blk in blocks]
    tensors = [params[f"transformer.h.{i}.{n}"] for i, ns in zip(layers, names) for n in ns]
    rope = (model.rope_cos, model.rope_sin)

    def run(x, *tensors):
        at = 0
        for i, blk, ns in zip(layers, blocks, names):
            p = dict(zip(ns, tensors[at:at + len(ns)]))
            at += len(ns)
            seeds = None if layer_seeds is None else layer_seeds[i]
            x = functional_call(blk, p, (x, cfg, model.qkv_perm, rope, segment_ids, seeds,
                                         seg_bounds))
        return x

    if not remat:
        return run(x, *tensors)
    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if cfg.remat_policy == "dots" else noop_context_fn)
    return checkpoint(run, x, *tensors, use_reentrant=False, context_fn=context_fn,
                      preserve_rng_state=False)


def readout(model: OmniBioTA, params: Mapping[str, torch.Tensor], h: torch.Tensor,
            tokens: torch.Tensor, mask: torch.Tensor, capacity_frac: float):
    """ln_f and the masked readout of the last layer's output h: (NLL sum,
    masked count) of the micro-batch's rows."""
    emb = _layer_norm(h, params["transformer.ln_f.weight"],
                      params.get("transformer.ln_f.bias"))
    nll, count = masked_nll(model.cfg, emb, tokens, mask, params["lm_head.weight"],
                            capacity_frac)
    return nll.sum(), count


def _exchange(send: Optional[torch.Tensor], to: Optional[int], frm: Optional[int],
              recv: dict) -> Optional[torch.Tensor]:
    """Send `send` to global rank `to` and receive a tensor of `recv`'s
    size, dtype and device from `frm` (either may be None), in one
    batch_isend_irecv."""
    ops, out = [], None
    if send is not None:
        ops.append(dist.P2POp(dist.isend, send.contiguous(), to))
    if frm is not None:
        out = torch.empty(**recv)
        ops.append(dist.P2POp(dist.irecv, out, frm))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def pipeline_step(model: OmniBioTA, stage: Stage, params: Mapping[str, torch.Tensor],
                  tokens: torch.Tensor, segments: torch.Tensor, weights: Sequence[float],
                  seeds: Sequence[int], *, mask_prob: float = 0.15,
                  deterministic: bool = False, masks: Optional[torch.Tensor] = None,
                  mask_rows: Optional[Tuple[int, int]] = None, data_group=None,
                  backward: bool = True):
    """One pass of the A micro-batches tokens / segments (A, B, T) through
    the schedule: (this rank's share of Σ_j w_j·NLL_j / masked_j, of Σ_j
    w_j·masked_j, of the active slots' non-PAD tokens), 0-d tensors whose
    sums over the mesh are the step's. With `backward`, the gradients of
    the loss share summed over the stages have accumulated in the `.grad`
    of the tensors of `params` this stage used (the caller's leaves).

    seeds: slot j's integer seed; masks: explicit (A, B, T) masks;
    mask_rows=(first, total): the tokens are those rows of the global
    micro-batches (dp × pp), whose masks are drawn whole; data_group: the
    group the rows are cut over (masked counts summed over it)."""
    cfg = model.cfg
    capacity_frac = _default_capacity_frac(mask_prob)
    A, B, T = tokens.shape
    if T > cfg.block_size:
        raise ValueError(f"Cannot forward sequence of length {T}, block size is only "
                         f"{cfg.block_size}")
    S, s = stage.size, stage.index
    layers = stage.layers(cfg.n_layer)
    active = [j for j, w in enumerate(weights) if w != 0.0]
    M = len(active)
    remat = backward and cfg.checkpoint_freq > 0
    dev = tokens.device
    draws = [micro_draws(model, tokens[j], seeds[j], mask_prob=mask_prob,
                         deterministic=deterministic,
                         mask=None if masks is None else masks[j], mask_rows=mask_rows)
             for j in active]
    hidden_spec = dict(size=(B, T, cfg.n_embd), dtype=cfg.cdtype(), device=dev)

    # forward: at tick t stage s runs micro-batch m = t - s
    kept: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
    recv = None
    for t in range(M + S - 1):
        m = t - s
        h = None
        if 0 <= m < M:
            j = active[m]
            mask, emb_seed, layer_seeds = draws[m]
            if s == 0:
                x = embed(model, params, apply_mlm_mask(tokens[j], mask), emb_seed)
            else:
                x = recv.requires_grad_(backward)
            seg = segments[j].to(torch.int32)
            h = run_layers(model, params, layers, x, seg, SegmentBounds(seg), layer_seeds,
                           remat)
            kept[m] = (x, h)
        recv = _exchange(None if h is None or stage.next is None else h.detach(),
                         stage.next, stage.prev if s > 0 and 0 <= m + 1 < M else None,
                         hidden_spec)

    # readout: head balance spreads the slots' CE over the stages
    balance = S > 1 and A % S == 0
    if balance:
        group_size = A // S
        own = [m for m, j in enumerate(active) if j // group_size == s]
        finals = (torch.stack([kept[m][1].detach() for m in range(M)]) if stage.is_last
                  else torch.empty((M, *hidden_spec["size"]), dtype=cfg.cdtype(), device=dev))
        dist.broadcast(finals, src=stage.last_rank, group=stage.group)
        finals.requires_grad_(backward)
        hidden = {m: finals[m] for m in own}
    else:
        own = list(range(M)) if stage.is_last else []
        hidden = {m: kept[m][1].detach().requires_grad_(backward) for m in own}
    loss = torch.zeros((), device=dev)
    masked = torch.zeros((), device=dev)
    if own:
        nll_sums, counts = zip(*(readout(model, params, hidden[m], tokens[active[m]],
                                         draws[m][0], capacity_frac) for m in own))
        counts = torch.stack(counts)
        denom = counts
        if data_group is not None:
            denom = counts.clone()
            dist.all_reduce(denom, group=data_group)
        denom = denom.clamp_min(1)
        for i, m in enumerate(own):
            w = weights[active[m]]
            loss = loss + w * (nll_sums[i] / denom[i])
            masked = masked + w * counts[i]
    seen = torch.zeros((), dtype=torch.int64, device=dev)
    if s == 0:
        for j in active:
            seen = seen + (tokens[j] != PAD_TOKEN).sum()
    if not backward:
        return loss, masked, seen

    # backward: the readout, the hidden states' cotangents to the last
    # stage, then the ticks in reverse
    if own:
        torch.autograd.backward(loss)
    if balance:
        cot = finals.grad if finals.grad is not None else torch.zeros_like(finals)
        del finals, hidden
        dist.reduce(cot, dst=stage.last_rank, group=stage.group)
        cots = {m: cot[m] for m in range(M)} if stage.is_last else {}
    else:
        cots = {m: hidden[m].grad for m in own}
        del hidden
    recv = None
    for t in reversed(range(M + S - 1)):
        m = t - s
        gx = None
        if 0 <= m < M:
            x, h = kept.pop(m)
            torch.autograd.backward(h, cots.pop(m) if stage.is_last else recv)
            if s > 0:
                gx = x.grad
            del x, h
        recv = _exchange(gx, stage.prev,
                         stage.next if not stage.is_last and 0 <= m - 1 < M else None,
                         hidden_spec)
    return loss.detach(), masked, seen
