"""Metric sinks and MFU accounting.

Port of `omnibiote_tpu/training/metrics.py`: a JSONL sink (always), an
optional wandb mirror, the reference's analytic FLOPs/token formula
`6N + 12·L·d·T` (train_encoder.py:360) and the executed-FLOP accounting
(`flops_per_token_executed`). MFU here is against one NVIDIA H100 SXM's
dense bf16 tensor-core peak (989 TFLOP/s, NVIDIA's data sheet), not a TPU's.
"""
from __future__ import annotations

import json
import os
import sys
import time
import warnings
from typing import IO, Optional, Tuple

import numpy as np

from ..ops.flash_attention import kernel_tiles

# Dense bf16 tensor-core peak of one H100 SXM at its 700 W limit (NVIDIA
# data sheet); the denominator of `mfu`.
H100_BF16_DENSE_PEAK_FLOPS = 989e12


def flops_per_token(n_params_non_emb: int, n_layer: int, n_embd: int,
                    ctx_len: int) -> float:
    """Reference estimate: 6N + 12·L·d·T (train_encoder.py:360)."""
    return 6.0 * n_params_non_emb + 12.0 * n_layer * n_embd * ctx_len


def mfu(tokens_per_sec: float, fpt: float, n_gpus: int = 1) -> float:
    """Model FLOPs utilisation vs the H100 bf16 dense peak."""
    return tokens_per_sec * fpt / (H100_BF16_DENSE_PEAK_FLOPS * n_gpus)


# --------------------------------------------------------------------------
# Executed-FLOP accounting
#
# The nominal formula credits work the port skips: (a) the full-vocab LM
# head at every position, while training/mlm.py computes it on
# capacity_frac·T slots; (b) dense T² attention, while the flash kernels
# skip fully masked cross-segment tiles. `mfu` (nominal) is the number to
# set against the reference; `mfu_executed` counts the FLOPs launched.
# Recompute FLOPs are not credited (the backward kernels' rebuilt scores,
# the second forward of rematerialisation), so mfu_executed is a lower
# bound on the tensor cores' occupancy.
# --------------------------------------------------------------------------

def attention_tile_fraction(segments, block_q: int, block_kv: int) -> float:
    """Fraction of (q-block, kv-block) tiles a kernel walks under segment
    skipping, given the batch's segment ids: per (row, q block) the
    contiguous kv-block range whose id ranges meet the q block's; an empty
    range still costs one masked tile (`ops/flash_attention.seg_block_bounds`).
    The blocks owned are the first argument, the blocks walked the second."""
    seg = np.asarray(segments)
    B, T = seg.shape
    nq, nk = T // block_q, T // block_kv
    qr = seg.reshape(B, nq, block_q)
    kr = seg.reshape(B, nk, block_kv)
    qmin, qmax = qr.min(-1), qr.max(-1)
    kmin, kmax = kr.min(-1), kr.max(-1)
    inter = ((kmin[:, None, :] <= qmax[:, :, None]) &
             (kmax[:, None, :] >= qmin[:, :, None]))     # (B, nq, nk)
    any_ = inter.any(-1)
    lo = np.where(any_, inter.argmax(-1), 0)
    hi = np.where(any_, nk - 1 - inter[:, :, ::-1].argmax(-1), 0)
    executed = np.where(any_, hi - lo + 1, 1)
    return float(executed.sum() / (B * nq * nk))


def flash_skip_fractions(segments) -> Tuple[float, float]:
    """(e_fwd, e_bwd) under the JAX package's TPU block policy: forward kv
    blocks span the sequence up to T=2048, 512 beyond; backward kv blocks
    span it up to T=1024, 512 beyond; q blocks are 512. Kept for parity
    with the JAX package; the port's kernels walk `kernel_skip_fractions`."""
    seg = np.asarray(segments)
    T = seg.shape[1]
    bq = min(512, T)
    fwd_bkv = T if T <= 2048 else 512
    bwd_bkv = T if T <= 1024 else 512
    return (attention_tile_fraction(seg, bq, fwd_bkv),
            attention_tile_fraction(seg, bq, bwd_bkv))


def kernel_skip_fractions(segments, dtype, fused: bool = True,
                          head_dim: int = 128) -> Tuple[float, float]:
    """(e_fwd, e_bwd) of the port's CUDA kernels at `dtype` and `head_dim`,
    on their own tiles (`ops/flash_attention.kernel_tiles`): the forward owns q tiles and
    walks kv tiles; the fused backward and the dkv kernel own kv tiles and
    walk q tiles; the dq kernel owns q tiles and walks kv tiles. With
    fused=False (the split pair) e_bwd weighs dkv's fraction by the three
    backward products it does (dV, dP, dK) and dq's by its one (dQ)."""
    fq, fkv = kernel_tiles("fwd", dtype, head_dim)
    e_fwd = attention_tile_fraction(segments, fq, fkv)
    bq, bkv = kernel_tiles("fused" if fused else "dkv", dtype, head_dim)
    e_kv = attention_tile_fraction(segments, bkv, bq)
    if fused:
        return e_fwd, e_kv
    dq, dkv = kernel_tiles("dq", dtype, head_dim)
    return e_fwd, (3.0 * e_kv + attention_tile_fraction(segments, dq, dkv)) / 4.0


def flops_per_token_executed(n_params_non_emb: int, n_layer: int,
                             n_embd: int, ctx_len: int, *,
                             vocab_size: int = 2 ** 16,
                             capacity_frac: float = 0.25,
                             segments=None,
                             attn_impl: str = "flash",
                             fractions: Optional[Tuple[float, float]] = None
                             ) -> float:
    """Executed FLOPs a token: the nominal estimate less (a) the LM-head
    positions the compacted MLM head never computes (capacity_frac·T slots
    instead of T) and (b) the attention tiles segment skipping leaves out,
    weighted 1/3 forward and 2/3 backward as the nominal 12·L·d·T term
    splits. `fractions` (e_fwd, e_bwd), e.g. `kernel_skip_fractions`, are
    the executed tile fractions; without them `segments` are read under
    the JAX package's blocks (`flash_skip_fractions`). Neither (or a
    non-flash impl) credits dense attention."""
    fpt = flops_per_token(n_params_non_emb, n_layer, n_embd, ctx_len)
    fpt -= 6.0 * n_embd * vocab_size * (1.0 - capacity_frac)
    if attn_impl == "flash" and (fractions is not None or segments is not None):
        e_fwd, e_bwd = (flash_skip_fractions(segments) if fractions is None
                        else fractions)
        attn = 12.0 * n_layer * n_embd * ctx_len
        fpt -= attn * (1.0 - (e_fwd + 2.0 * e_bwd) / 3.0)
    return fpt


class JsonlSink:
    """Append-only JSONL metrics (one object per log call)."""

    def __init__(self, path: Optional[str] = None, stream: Optional[IO] = None,
                 echo: bool = False):
        self.path = path
        self._f: Optional[IO] = stream
        self.echo = echo
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")

    def log(self, record: dict):
        record = dict(record)
        record.setdefault("ts", time.time())
        line = json.dumps(record)
        if self._f is not None:
            self._f.write(line + "\n")
            self._f.flush()
        if self.echo:
            print(line, file=sys.stderr)

    def close(self):
        if self._f is not None and self.path is not None:
            self._f.close()


class WandbSink:
    """Optional wandb mirror: a no-op unless enabled, wandb is installed
    and `wandb.init` succeeds (as the JAX sink, a run without network or
    credentials logs on without wandb)."""

    def __init__(self, project: str = "omnibiota", enabled: bool = False):
        self._run = None
        if not enabled:
            return
        try:
            import wandb
            self._run = wandb.init(project=project)
        except Exception as e:   # no wandb, no network or no login: log on
            warnings.warn(f"wandb disabled: {e!r}")
            self._run = None

    def log(self, record: dict):
        if self._run is not None:
            self._run.log(record, step=record.get("tokens"))

    def close(self):
        if self._run is not None:
            self._run.finish()


class MultiSink:
    def __init__(self, *sinks):
        self.sinks = [s for s in sinks if s is not None]

    def log(self, record: dict):
        for s in self.sinks:
            s.log(record)

    def close(self):
        for s in self.sinks:
            s.close()
