"""OmniBioTA: bidirectional RoPE transformer encoder, PyTorch port.

Counterpart of `omnibiote_tpu/models/omnibiota.py`, as an `nn.Module`
whose `state_dict` has the reference's layout (torch Linear weights are
(out, in)):

  transformer.wte.weight               (V, D)
  transformer.h.{i}.ln_1.weight        (D,)      [+ .bias when bias=True]
  transformer.h.{i}.attn.c_attn.weight (3D, D)
  transformer.h.{i}.attn.c_proj.weight (D, D)
  transformer.h.{i}.ln_2.weight        (D,)
  transformer.h.{i}.mlp.c_fc.weight    (4D, D)
  transformer.h.{i}.mlp.c_proj.weight  (D, 4D)
  transformer.ln_f.weight              (D,)
  lm_head.weight                       (V, D)

Architecture: wte -> N * [x + attn(ln1(x)); x + mlp(ln2(x))] -> ln_f, RoPE
on q and k, µP attention scale 8/n_embd, erf-GELU with the reference's
1.41421 constant, LayerNorm eps 1e-5 with fp32 statistics, and the µP
readout logits = (x * output_mult / width_mult) @ lm_headᵀ. Dtypes follow
the JAX package: embeddings are gathered, then cast to compute_dtype, and
each linear casts its weight to the activation dtype.

Training forward (deterministic=False, dropout > 0): inverted dropout on the
embeddings and on both residual branches of every block, and dropout on the
attention probabilities, as the JAX package places them. Its randomness
comes from one integer seed (`rng`, the counterpart of the JAX key), from
which the host derives a seed for the embedding mask and, per layer, one
for each of its three sites (`attn`, `resid1`, `resid2`), as the JAX
package splits its key per (layer, site) (`_forward_rngs`). Each mask is a
pure function of its seed: a residual mask comes from a generator seeded
when it is drawn, the attention's from the kernels' Philox stream keyed by
its seed. So a forward never waits for the device, and a block run twice
with the same seeds draws the same masks.

Rematerialisation (cfg.checkpoint_freq > 0, training with gradients):
every block runs under `torch.utils.checkpoint` (non-reentrant), as the
JAX package wraps every scanned block in `jax.checkpoint` for any
checkpoint_freq > 0. remat_policy 'dots' saves the outputs of the four
projections (`aten.mm` / `aten.addmm`, not the batched `aten.bmm`: the JAX
package's dots_with_no_batch_dims_saveable) and recomputes the rest; any
other policy recomputes the whole block. The masks' seeds make the
recompute draw the same masks, so remat changes no gradient.

On a mesh (parallel/): every dropout seed is mixed with the rank's
data-axis index (`data_seed`), so data ranks draw different masks for their
rows and the ranks of one model group the same residual masks; with tensor
parallelism (`tp`) the module holds the rank's heads, its block of the MLP
and of the vocabulary, and the collectives of parallel/tensor.py join them.
With sequence parallelism (`ring`, cfg.attn_impl='ring') the forward takes
the rank's (B, Tl) block of positions [i·Tl, (i+1)·Tl) of every row: RoPE
reads those rows of its tables, attention is ops/ring_attention.py with one
RingSegments a forward (the ids gathered over the seq axis once, the N
rotations' bounds shared by every layer and both directions), and the
embedding and residual masks are that block of the whole sequence's draw,
so a block is not keyed by its local positions. cfg.attn_impl='ring' with
no ring is a ring of one.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..config import OmniBioTAConfig
from ..ops.attention import attention
from ..ops.flash_attention import SegmentBounds
from ..ops.ring_attention import Ring, RingSegments
from ..ops.quant import QuantizedWeight, quant_linear
from ..parallel.tensor import (TensorParallel, block_rows, copy_to_model,
                               gather_from_model, qkv_rows, reduce_from_model)
from ..utils.device import resolve_device
from .rope import qkv_col_perm, rope_tables


# --------------------------------------------------------------------------
# Functional pieces
# --------------------------------------------------------------------------

def _layer_norm(x, weight, bias=None, eps: float = 1e-5):
    """LayerNorm with optional bias, fp32 statistics, output in x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def _gelu_erf(x):
    """x * 0.5 * (1 + erf(x / 1.41421)): the reference's GELU with its
    truncated sqrt(2) constant."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / 1.41421))).to(x.dtype)


# Degree-7 (in u = x^2) fit of (Phi(x) - 0.5)/x on (0, 4], Phi the
# reference's Gaussian CDF; the activation is x*(0.5 + x*P(x^2)), clamped to
# the asymptotes outside |x| <= 4 (max abs error 1.27e-4 against erf-GELU).
_GELU_POLY = (
    3.9867681269e-01, -6.5885546573e-02, 9.5017678048e-03, -1.0051514547e-03,
    7.4631021951e-05, -3.6379394711e-06, 1.0337561212e-07, -1.2874154492e-09,
)
_GELU_CUT = 4.0


def _gelu_fast(x):
    """Polynomial erf-GELU, the same function as _gelu_erf to 1.3e-4."""
    xf = x.float()
    xc = torch.where(xf > _GELU_CUT, _GELU_CUT,
                     torch.where(xf < -_GELU_CUT, -_GELU_CUT, xf))
    u = xc * xc
    p = torch.full_like(u, _GELU_POLY[-1])
    for c in _GELU_POLY[-2::-1]:
        p = p * u + c
    y = xc * (0.5 + xc * p)
    y = torch.where(xf > _GELU_CUT, xf, y)
    y = torch.where(xf < -_GELU_CUT, 0.0, y)
    return y.to(x.dtype)


def _gelu(x, cfg: OmniBioTAConfig):
    mode = "erf" if cfg.gelu == "auto" else cfg.gelu
    if mode not in ("erf", "fast"):
        raise ValueError(f"gelu must be 'auto', 'erf' or 'fast', got {cfg.gelu!r}")
    return _gelu_fast(x) if mode == "fast" else _gelu_erf(x)


def _dropout(x, rate: float, seed: Optional[int],
             cols: Optional[Tuple[int, int]] = None):
    """Inverted dropout from raw random bits: keep iff the 32 bits >=
    ⌊rate·2³²⌋ (the JAX package's `_dropout` rule, the same as the flash
    kernel's), then x / (1 - rate) in x's dtype. The bits come from a
    generator on x's device seeded with `seed` here, so the mask is a pure
    function of the seed; they are drawn as int32 and compared offset by
    2³¹, which is the unsigned comparison. cols=(first, total): x (B, Tl,
    ...) holds positions first.. of a sequence of `total`, and takes those
    positions of the whole sequence's draw."""
    if seed is None or rate == 0.0:
        return x
    gen = torch.Generator(device=x.device)
    gen.manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    thresh = min(int(rate * (2.0 ** 32)), 2 ** 32 - 1)
    shape = x.shape if cols is None else (x.shape[0], cols[1], *x.shape[2:])
    bits = torch.randint(-2 ** 31, 2 ** 31, shape, generator=gen,
                         device=x.device, dtype=torch.int32)
    if cols is not None:
        bits = bits[:, cols[0]:cols[0] + x.shape[1]]
    return torch.where(bits >= thresh - 2 ** 31, x / (1.0 - rate),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# A layer's dropout seeds: (attn, resid1, resid2).
LayerSeeds = Tuple[int, int, int]

# Odd multiplier that mixes a data-axis index into a dropout seed (the
# model axis has its own, ops/flash_attention.py TP_SEED_MIX).
DATA_SEED_MIX = 0x85EBCA6B


def data_seed(seed: int, data_index: int) -> int:
    """The seed of a dropout call on data rank `data_index`: every mask is
    keyed by the row index a rank sees, so without the mix all data ranks
    would draw the same masks for their own rows."""
    return (int(seed) ^ (int(data_index) * DATA_SEED_MIX)) & 0xFFFFFFFFFFFFFFFF


def _forward_rngs(rng: int, n_layer: int, data_index: int = 0):
    """(embedding seed, [per-layer (attn, resid1, resid2) seeds]) from the
    forward's integer seed, each mixed with the data-axis index; host-side
    only."""
    words = [data_seed(w, data_index) for w in np.random.SeedSequence(
        int(rng)).generate_state(1 + 3 * n_layer, np.uint64)]
    return words[0], [tuple(words[1 + 3 * i:4 + 3 * i]) for i in range(n_layer)]


def _dots_policy(ctx, op, *args, **kwargs):
    """remat_policy 'dots': keep the unbatched products' outputs."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _linear(x, w, b=None):
    """x @ wᵀ with w (out, in) cast to x's dtype, then the bias (cast to
    the product's dtype) added separately, as the JAX package does. A
    QuantizedWeight takes the int8 serving path (ops/quant.py)."""
    if isinstance(w, QuantizedWeight):
        return quant_linear(x, w, b)
    y = F.linear(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


# --------------------------------------------------------------------------
# Modules (parameter containers in the reference layout)
# --------------------------------------------------------------------------

def _param(*shape, device, dtype):
    return nn.Parameter(torch.empty(*shape, device=device, dtype=dtype))


class Linear(nn.Module):
    """A (fan_out, fan_in) weight; the bias has bias_out entries (default
    fan_out; a tensor-parallel rank keeps c_attn's and c_fc's whole)."""

    def __init__(self, fan_in: int, fan_out: int, bias: bool, *, device, dtype,
                 bias_out: Optional[int] = None):
        super().__init__()
        self.weight = _param(fan_out, fan_in, device=device, dtype=dtype)
        self.bias = (_param(bias_out or fan_out, device=device, dtype=dtype)
                     if bias else None)


class LayerNorm(nn.Module):
    def __init__(self, d: int, bias: bool, *, device, dtype):
        super().__init__()
        self.weight = _param(d, device=device, dtype=dtype)
        self.bias = _param(d, device=device, dtype=dtype) if bias else None

    def forward(self, x):
        return _layer_norm(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, n: int, d: int, *, device, dtype):
        super().__init__()
        self.weight = _param(n, d, device=device, dtype=dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: OmniBioTAConfig, *, device, dtype, tp_size: int = 1):
        super().__init__()
        D, Dl = cfg.n_embd, cfg.n_embd // tp_size
        self.c_attn = Linear(D, 3 * Dl, cfg.bias, device=device, dtype=dtype,
                             bias_out=3 * D)
        self.c_proj = Linear(Dl, D, cfg.bias, device=device, dtype=dtype)


class MLP(nn.Module):
    def __init__(self, cfg: OmniBioTAConfig, *, device, dtype, tp_size: int = 1):
        super().__init__()
        D = cfg.n_embd
        self.c_fc = Linear(D, 4 * D // tp_size, cfg.bias, device=device,
                           dtype=dtype, bias_out=4 * D)
        self.c_proj = Linear(4 * D // tp_size, D, cfg.bias, device=device, dtype=dtype)


def _row_parallel(y, w, b, tp: Optional[TensorParallel]):
    """y @ wᵀ (+ b): with tensor parallelism the partial products are
    summed over the model axis before the bias is added once."""
    if tp is None:
        return _linear(y, w, b)
    y = reduce_from_model(_linear(y, w), tp)
    return y if b is None else y + b.to(y.dtype)


class Block(nn.Module):
    def __init__(self, cfg: OmniBioTAConfig, *, device, dtype, tp_size: int = 1):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.n_embd, cfg.bias, device=device, dtype=dtype)
        self.attn = SelfAttention(cfg, device=device, dtype=dtype, tp_size=tp_size)
        self.ln_2 = LayerNorm(cfg.n_embd, cfg.bias, device=device, dtype=dtype)
        self.mlp = MLP(cfg, device=device, dtype=dtype, tp_size=tp_size)

    def forward(self, x, cfg: OmniBioTAConfig, qkv_perm, rope, segment_ids,
                seeds: Optional[LayerSeeds] = None, seg_bounds=None,
                tp: Optional[TensorParallel] = None, ring: Optional[Ring] = None):
        """seeds (the layer's (attn, resid1, resid2) dropout seeds) are
        given when training with dropout, None otherwise. seg_bounds: the
        SegmentBounds of segment_ids that all layers share (a RingSegments
        under a ring). tp: this rank's place on the model axis (its heads
        and its block of the MLP; parallel/tensor.py), None without tensor
        parallelism. ring: this rank's place on the seq axis (x holds its
        block of positions), None without sequence parallelism."""
        B, T, D = x.shape
        cols = None if ring is None else (ring.index * T, ring.size * T)
        rate = cfg.dropout if seeds is not None else 0.0
        attn_seed, resid1, resid2 = seeds if seeds is not None else (None,) * 3
        M = 1 if tp is None else tp.size
        H, Dh, Dl = cfg.n_head // M, cfg.head_dim, D // M
        # attention: RoPE's pair de-interleave is folded into the q and k
        # output rows of c_attn (a shared head_dim permutation of q and k
        # leaves attention invariant), so the kernel rotates halves
        h = self.ln_1(x)
        w, b = self.attn.c_attn.weight, self.attn.c_attn.bias
        if tp is not None:
            h = copy_to_model(h, tp)
            b = None if b is None else b[qkv_rows(D, tp).to(b.device)]
        if not cfg.qkv_prepermuted:
            w = w[qkv_perm]
            b = None if b is None else b[qkv_perm]
        q, k, v = _linear(h, w, b).split(Dl, dim=-1)
        y = attention(
            q.reshape(B, T, H, Dh), k.reshape(B, T, H, Dh),
            v.reshape(B, T, H, Dh), scale=cfg.attn_scale,
            segment_ids=segment_ids, causal=cfg.autoregressive,
            dropout_rate=rate, dropout_seed=attn_seed, impl=cfg.attn_impl,
            rope=rope, int8=cfg.attn_int8 and seeds is None,
            seg_bounds=seg_bounds, tp_mesh=tp, ring_mesh=ring)
        y = _row_parallel(y.reshape(B, T, Dl), self.attn.c_proj.weight,
                          self.attn.c_proj.bias, tp)
        x = x + _dropout(y, rate, resid1, cols)
        # MLP
        h = self.ln_2(x)
        b = self.mlp.c_fc.bias
        if tp is not None:
            h = copy_to_model(h, tp)
            b = None if b is None else b[block_rows(4 * D, tp)]
        h = _linear(h, self.mlp.c_fc.weight, b)
        h = _gelu(h, cfg)
        h = _row_parallel(h, self.mlp.c_proj.weight, self.mlp.c_proj.bias, tp)
        return x + _dropout(h, rate, resid2, cols)


def _rematted_block(blk: Block, x, cfg: OmniBioTAConfig, *args):
    """blk(x, cfg, *args) under torch.utils.checkpoint. The block's
    parameters go in as the checkpoint's inputs, taken as the forward sees
    them: under `functional_call` (the train step's bf16 compute copy) the
    recompute, which runs after that call has returned, must use those
    tensors and not the module's own."""
    names, tensors = zip(*blk.named_parameters())

    def run(x, *params):
        return functional_call(blk, dict(zip(names, params)), (x, cfg, *args))

    context_fn = (functools.partial(create_selective_checkpoint_contexts, _dots_policy)
                  if cfg.remat_policy == "dots" else noop_context_fn)
    # every mask is keyed by its seed: no global RNG state to stash
    return checkpoint(run, x, *tensors, use_reentrant=False,
                      context_fn=context_fn, preserve_rng_state=False)


class OmniBioTA(nn.Module):
    """The encoder with uninitialised parameters in cfg.param_dtype on
    `device` (None: the GPU); see init_params for the µP initialisation.

    tp: this rank's place on a tensor-parallel model axis; the module then
    holds the rank's heads, its block of the MLP and of the vocabulary
    (parallel/tensor.py). data_index: this rank's data-axis index, mixed
    into every dropout seed (`data_seed`). ring: this rank's place on the
    seq axis (ops/ring_attention.py); the forward then takes its block of
    positions (cfg.attn_impl must be 'ring')."""

    def __init__(self, cfg: OmniBioTAConfig, *, device=None,
                 tp: Optional[TensorParallel] = None, data_index: int = 0,
                 ring: Optional[Ring] = None):
        super().__init__()
        dev = resolve_device(device)
        pdt = cfg.pdtype()
        M = 1 if tp is None else tp.size
        if cfg.n_head % M or cfg.vocab_size % M:
            raise ValueError(f"n_head {cfg.n_head} and vocab_size {cfg.vocab_size} "
                             f"must divide by the model axis ({M})")
        D, H, Dh, Dl = cfg.n_embd, cfg.n_head // M, cfg.head_dim, cfg.n_embd // M
        if ring is not None and cfg.attn_impl != "ring":
            raise ValueError("a ring (sequence parallelism) needs attn_impl='ring'")
        self.cfg = cfg
        self.tp = tp
        self.data_index = data_index
        self.ring = ring
        self.transformer = nn.ModuleDict(dict(
            wte=Embedding(cfg.vocab_size, D, device=dev, dtype=pdt),
            h=nn.ModuleList([Block(cfg, device=dev, dtype=pdt, tp_size=M)
                             for _ in range(cfg.n_layer)]),
            ln_f=LayerNorm(D, cfg.bias, device=dev, dtype=pdt),
        ))
        self.lm_head = Linear(D, cfg.vocab_size // M, False, device=dev, dtype=pdt)
        cos, sin = rope_tables(Dh, cfg.block_size, cfg.rope_theta, device=dev)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        col = torch.as_tensor(qkv_col_perm(H, Dh), device=dev)
        perm = torch.cat([col, Dl + col, torch.arange(2 * Dl, 3 * Dl, device=dev)])
        self.register_buffer("qkv_perm", perm, persistent=False)

    def forward(self, idx, segment_ids=None, *, deterministic: bool = True,
                rng: Optional[int] = None, return_embeddings: bool = False):
        """Logits (B, T, V) or, with return_embeddings, the final-LN hidden
        states (B, T, D). segment_ids (B, T) int32 or None (dense).
        deterministic=False is the training forward and needs the integer
        seed `rng`; it draws dropout only when cfg.dropout > 0. Under a
        ring, idx and segment_ids are this rank's block of positions of
        sequences N times as long, and so are the outputs."""
        cfg = self.cfg
        ring = self.ring
        if ring is None and cfg.attn_impl == "ring":
            ring = Ring(None, 0, 1)
        Tl = idx.shape[1]
        T, at = (Tl, 0) if ring is None else (ring.size * Tl, ring.index * Tl)
        if T > cfg.block_size:
            raise ValueError(f"Cannot forward sequence of length {T}, block "
                             f"size is only {cfg.block_size}")
        seg_bounds = None
        if segment_ids is not None:
            segment_ids = segment_ids.to(torch.int32)
            # the attention's skip bounds: one holder per forward, filled
            # once per tile size and read by every layer, both directions
            # (under a ring: the ids gathered once, a holder a rotation)
            seg_bounds = (SegmentBounds(segment_ids) if ring is None
                          else RingSegments.gather(segment_ids, ring))
        # F.embedding, not indexing: its backward sums repeated ids in a
        # fixed order (indexing's index_put_ accumulates in no fixed order)
        x = F.embedding(idx.long(), self.transformer.wte.weight).to(cfg.cdtype())
        seeds = [None] * cfg.n_layer
        if not deterministic:
            if rng is None:
                raise ValueError("training forward requires rng")
            if cfg.dropout > 0.0:
                emb_seed, seeds = _forward_rngs(rng, cfg.n_layer, self.data_index)
                x = _dropout(x, cfg.dropout, emb_seed,
                             None if ring is None else (at, T))
        rope = (self.rope_cos, self.rope_sin)
        if ring is not None:   # RoPE at the positions this rank holds
            rope = (self.rope_cos[at:at + Tl], self.rope_sin[at:at + Tl])
        remat = (cfg.checkpoint_freq > 0 and not deterministic
                 and torch.is_grad_enabled())
        for blk, layer_seeds in zip(self.transformer.h, seeds):
            args = (cfg, self.qkv_perm, rope, segment_ids, layer_seeds,
                    seg_bounds, self.tp, ring)
            x = _rematted_block(blk, x, *args) if remat else blk(x, *args)
        emb = self.transformer.ln_f(x)
        if return_embeddings:
            return emb
        scale = torch.tensor(cfg.mup_output_mult / cfg.width_mult,
                             dtype=emb.dtype, device=emb.device)
        if self.tp is None:
            return _linear(emb * scale, self.lm_head.weight)
        logits = _linear(copy_to_model(emb * scale, self.tp), self.lm_head.weight)
        return gather_from_model(logits, self.tp)


# --------------------------------------------------------------------------
# Initialisation and the functional surface of the JAX package
# --------------------------------------------------------------------------

@torch.no_grad()
def init_params(generator: torch.Generator, cfg: OmniBioTAConfig, *,
                device=None) -> OmniBioTA:
    """A model with the µP initialisation of the reference (torch defaults
    under mup.set_base_shapes):
      * embedding N(0, 1);
      * hidden Linear W ~ U(±1/sqrt(fan_in));
      * readout W ~ U(±1/sqrt(fan_in)) * sqrt(width_mult) (the forward
        divides by width_mult);
      * LayerNorm weight 1, every bias 0.
    Values are drawn in fp32 on the generator's device, then cast and moved."""
    model = OmniBioTA(cfg, device=device)
    gdev = generator.device
    D = cfg.n_embd

    def fill_uniform(p, bound):
        r = torch.empty(p.shape, device=gdev).uniform_(-bound, bound, generator=generator)
        p.copy_(r)

    for name, p in model.named_parameters():
        if name.endswith(".bias"):
            p.zero_()
        elif ".ln_" in name:
            p.fill_(1.0)
    model.transformer.wte.weight.copy_(
        torch.randn(model.transformer.wte.weight.shape, generator=generator,
                    device=gdev))
    for blk in model.transformer.h:
        fill_uniform(blk.attn.c_attn.weight, 1.0 / math.sqrt(D))
        fill_uniform(blk.attn.c_proj.weight, 1.0 / math.sqrt(D))
        fill_uniform(blk.mlp.c_fc.weight, 1.0 / math.sqrt(D))
        fill_uniform(blk.mlp.c_proj.weight, 1.0 / math.sqrt(4 * D))
    fill_uniform(model.lm_head.weight,
                 (1.0 / math.sqrt(D)) * math.sqrt(cfg.width_mult))
    return model


def num_params(model: OmniBioTA, non_embedding: bool = True) -> int:
    """Parameter count; non_embedding subtracts wte only."""
    total = sum(p.numel() for p in model.parameters())
    if non_embedding:
        total -= model.transformer.wte.weight.numel()
    return total


def forward(model: OmniBioTA, idx, segment_ids=None, *,
            deterministic: bool = True, rng: Optional[int] = None,
            return_embeddings: bool = False):
    """Functional form of OmniBioTA.forward, mirroring the JAX package."""
    return model(idx, segment_ids, deterministic=deterministic, rng=rng,
                 return_embeddings=return_embeddings)


POOLINGS = ("mean", "first", "last", "max", "all")


@torch.inference_mode()
def encode(model: OmniBioTA, idx, method: str = "mean"):
    """Pooled sequence embeddings in the compute dtype. Like the reference,
    no attention mask: padded positions are visible here."""
    if method not in POOLINGS:
        raise ValueError(f"Unknown pooling method {method}")
    emb = model(idx, None, return_embeddings=True)
    if method == "mean":
        return emb.mean(dim=1)
    if method == "first":
        return emb[:, 0]
    if method == "last":
        return emb[:, -1]
    if method == "max":
        return emb.amax(dim=1)
    return emb
