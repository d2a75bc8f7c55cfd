"""Attention dispatch: the multi-head flash kernel, the int8 serving
kernel or the dense reference.

Routes as `omnibiote_tpu/ops/attention.py` does on one device
(`attention_path`): bidirectional attention at T % 128 == 0 with head_dim %
128 == 0 (or one head) goes to `flash_attention` (the CUDA kernels, forward
and backward, on a CUDA tensor; their plain versions on a CPU tensor); with
int8=True, no dropout and head_dim % 128 == 0 it goes to
`int8_flash_attention` (ops/int8_attention.py) instead; everything else
(causal, ragged T, narrow heads) goes to `xla_attention`, the dense twin of
the JAX package's reference path. The kernels take head dims 64, 128, 256
and every multiple of 128 past 256 (int8: every multiple of 128); one head
at any other head dim runs the kernels of the next one they take on
zero-padded inputs (`flash_attention_padded`), so every head dim the JAX
dispatch sends to a kernel has one. On a CUDA tensor a call that this
routing sends to a kernel not built for its dtype raises
NotImplementedError: it does not run densely in the kernel's place.

Dropout: `dropout_seed` is the call's 64-bit seed (the counterpart of the
JAX package's `dropout_rng` key). The flash path hands it to the kernels'
Philox stream; the dense path seeds a generator on the tensors' device
with it and keeps each probability with chance 1 - rate, as the JAX dense
path's bernoulli does.

Tensor parallelism (`tp_mesh`: the rank's `parallel.tensor.TensorParallel`):
q, k and v hold the rank's heads; the call routes on the model's heads (the
rank's times the model axis's size), as the JAX dispatch routes on
`cfg.n_head`; the flash path runs `flash_attention_tp` on the rank's heads,
with no communication and the dropout seed mixed with the model-axis index,
and the dense path mixes its seed the same way. As in the JAX dispatch,
such a call never takes the int8 kernel.

Sequence parallelism (impl='ring', `ring_mesh`: the rank's
`ops.ring_attention.Ring`, None for a ring of one): q, k and v hold the
rank's block of positions; RoPE is applied here from the tables the caller
passes (the rows of those positions), then `ring_attention` runs with
`seg_bounds` as its RingSegments. No causal mask, never int8.
"""
from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import KERNEL_DTYPES, flash_attention, flash_attention_tp, tp_seed
from .int8_attention import KERNEL_DTYPES as INT8_DTYPES
from .int8_attention import int8_flash_attention
from .ring_attention import Ring, RingSegments, ring_attention
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


def attention_path(device_type: str, dtype: torch.dtype, T: int, H: int,
                   D: int, int8: bool, *, impl: str = "flash",
                   causal: bool = False, dropout_rate: float = 0.0) -> str:
    """The path of one attention call of H heads (the model's, under tensor
    parallelism): 'int8', 'flash' or 'xla', as the JAX dispatch routes it.
    The kernels take every head dim routed to them (flash: D % 128 == 0
    (`flash_attention.kernel_head_dim`) and one head at any D, padded;
    int8: D % 128 == 0); on 'cuda' a call routed to a kernel that is not
    built for its dtype raises NotImplementedError; on the CPU the plain
    versions take any dtype."""
    if impl != "flash" or causal or T % 128:
        return "xla"
    if int8 and dropout_rate == 0.0 and D % 128 == 0:
        path, dtypes = "int8", INT8_DTYPES
    elif D % 128 == 0 or H == 1:
        path, dtypes = "flash", KERNEL_DTYPES
    else:
        return "xla"
    if device_type == "cuda" and dtype not in dtypes:
        raise NotImplementedError(
            f"no {path} attention kernel is built for head_dim {D} and {dtype}")
    return path


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
    path's skip bounds are computed once per batch and tile size. tp_mesh:
    the rank's TensorParallel place (q, k, v hold its heads), or None.
    ring_mesh: the rank's Ring (q, k, v hold its block of positions, rope
    the tables' rows of them; seg_bounds its RingSegments), or None."""
    if impl == "ring" or ring_mesh is not None:
        if causal:
            raise ValueError(
                "ring attention has no causal support: it would be silently "
                "bidirectional; use impl='xla' for autoregressive configs")
        if rope is not None:
            from ..models.rope import apply_rope_half
            q, k = apply_rope_half(q, k, rope[0], rope[1])
        ring = ring_mesh if ring_mesh is not None else Ring(None, 0, 1)
        return ring_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            scale=scale, ring=ring, dropout_rate=dropout_rate,
            seed=dropout_seed,
            segments=seg_bounds if isinstance(seg_bounds, RingSegments) else None)
    T, H, D = q.shape[1], q.shape[2], q.shape[3]
    int8 = int8 and tp_mesh is None
    n_head = H * (1 if tp_mesh is None else tp_mesh.size)
    path = attention_path(q.device.type, q.dtype, T, n_head, D, int8, impl=impl,
                          causal=causal, dropout_rate=dropout_rate)
    if path == "int8":
        # serving-only int8 kernel: RoPE and the quantization of q, k, v and
        # P all happen inside it; any other int8 call routes on as bf16
        return int8_flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), scale=scale,
            segment_ids=segment_ids, block_q=_fit_block(T, block_q),
            rope=rope)
    if block_kv is None:
        block_kv = T if T <= 1024 else 512
    if path == "flash":
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
        kw = dict(scale=scale, dropout_rate=dropout_rate,
                  seed=0 if dropout_seed is None else dropout_seed,
                  block_q=_fit_block(T, block_q), block_kv=_fit_block(T, block_kv),
                  block_kv_fwd=T if 1024 < T <= 2048 else None,
                  segment_skip=True, bounds=seg_bounds)
        if tp_mesh is not None:
            return flash_attention_tp(q.contiguous(), k.contiguous(), v.contiguous(),
                                      segment_ids, rope, model_index=tp_mesh.index, **kw)
        return flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), segment_ids,
            rope, **kw)
    if rope is not None:
        from ..models.rope import apply_rope_half
        q, k = apply_rope_half(q, k, rope[0], rope[1])
    if tp_mesh is not None and dropout_seed is not None:
        dropout_seed = tp_seed(dropout_seed, tp_mesh.index)
    return xla_attention(q, k, v, scale=scale, segment_ids=segment_ids,
                         causal=causal, dropout_rate=dropout_rate,
                         dropout_seed=dropout_seed)
