"""Metric sinks and MFU accounting.

Port of `omnibiote_tpu/training/metrics.py`: a JSONL sink (always), an
optional wandb mirror, and the reference's analytic FLOPs/token formula
`6N + 12·L·d·T` (train_encoder.py:360). MFU here is against one NVIDIA
H100 SXM's dense bf16 tensor-core peak (989 TFLOP/s, NVIDIA's data sheet),
not a TPU's.
"""
from __future__ import annotations

import json
import os
import sys
import time
import warnings
from typing import IO, Optional

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
