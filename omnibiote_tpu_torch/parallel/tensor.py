"""Tensor parallelism over the mesh's 'model' axis: Megatron's column and
row splits with the collectives written out as autograd Functions.

The JAX package annotates the projections (parallel/sharding.py `_tp_spec`)
and lets GSPMD insert the collectives. Here a model-axis rank holds

  * c_attn: whole heads of q, k and v (three row ranges of the (3D, D)
    weight, `qkv_rows`), c_fc: a block of the MLP's 4D rows — column
    parallel, their input passed through `copy_to_model` (identity forward,
    all-reduce of the input's gradient);
  * c_proj of attention and of the MLP: the matching columns — row
    parallel, their output summed by `reduce_from_model` (all-reduce
    forward, identity backward), the bias added once after it;
  * lm_head: a block of V/M vocabulary rows; the loss is a vocab-parallel
    logsumexp (ops/fused_ce.py with a group) and logits are gathered along
    the vocabulary by `gather_from_model`;
  * every norm, the embedding and the biases whole; c_attn's and c_fc's
    biases are sliced to the rank's rows in the forward, so their
    gradients are summed over the model axis after the backward.

Attention runs on the rank's heads with no communication
(ops/flash_attention.py `flash_attention_tp`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class TensorParallel(NamedTuple):
    """A rank's place on the model axis: its group, index and size."""
    group: object
    index: int
    size: int


def qkv_rows(n_embd: int, tp: TensorParallel) -> torch.Tensor:
    """The rows of the (3D, D) c_attn weight (the columns of the JAX
    package's (D, 3D) wqkv) that model rank tp.index holds: its heads'
    block of q, of k and of v."""
    w = n_embd // tp.size
    lo = tp.index * w
    return torch.cat([torch.arange(s + lo, s + lo + w) for s in (0, n_embd, 2 * n_embd)])


def block_rows(n: int, tp: TensorParallel) -> slice:
    """Model rank tp.index's contiguous block of n rows."""
    w = n // tp.size
    return slice(tp.index * w, (tp.index + 1) * w)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, index):
        ctx.index, ctx.width = index, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None, None


def copy_to_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward; the gradient is summed over the model axis."""
    return _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Sum over the model axis forward; identity backward."""
    return _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Concatenate the model ranks' blocks of the last dimension, in rank
    order; the gradient keeps this rank's block."""
    return _GatherFromModel.apply(x, tp.group, tp.size, tp.index)
