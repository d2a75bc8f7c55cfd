"""Generic fine-tuning engine for the downstream benchmark suite, PyTorch
port of `omnibiote_tpu/evals/engine.py`.

The reference's shared eval skeleton (its evals/gue.py:50-260; TAPE.py and
proteinGLUE.py repeat it with other heads):
  * optional domain-adaptive MLM pretraining over task sequences
  * per-task fine-tune: fresh linear head, AdamW with 3 LR groups
    (wte / rest / head@1e-2), OneCycleLR(pct_start=0.05), gradient
    accumulation with uniformly sampled micro-batches
  * periodic validation; best-on-val model selection; final test metrics
    from the best checkpoint

Batches and MLM masks come from `numpy.random.default_rng(seed)` in the
JAX package's order, so both packages train on the same batches. Dropout
(cfg.dropout > 0) draws from an integer seed per micro-batch derived from
(seed, step, micro-batch); its stream is the port's own.

A model passed in is never changed: the functions that train work on a
copy and return it.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import MASK_TOKEN, PAD_TOKEN, OmniBioTAConfig
from .common import (
    adamw, apply_linear_head, finetune_copy, init_linear_head, linear_to_zero,
    make_finetune_optimizer, pad_batch, restore, snapshot, step_optimizer,
    to_device, trainable)
from ..training.train import slot_seed
from .metrics import f1_score, matthews_corrcoef


# --------------------------------------------------------------------------
# Domain-adaptive MLM pretraining (gue.py:284-335)
# --------------------------------------------------------------------------

def mlm_nonpad_loss(model, tokens, segments, masked):
    """Mean CE of the fp32 logits over every non-PAD target (masked or
    not), the reference's domain-MLM loss (gue.py:326)."""
    logits = model(masked, segments, deterministic=True).float()
    nll = F.cross_entropy(logits.flatten(0, 1), tokens.flatten().long(),
                          reduction="none").view(tokens.shape)
    nonpad = tokens != PAD_TOKEN
    return torch.where(nonpad, nll, 0.0).sum() / nonpad.sum().clamp_min(1)


def domain_mlm_pretrain(
    model: torch.nn.Module,
    cfg: OmniBioTAConfig,
    tokenized: List[List[int]],
    *,
    num_epochs: int = 4,
    batch_size: int = 32,
    num_accumulation_steps: int = 4,
    lr: float = 1e-3,
    seed: int = 0,
    bucket: int = 128,
    max_len: Optional[int] = None,
    log: Optional[Callable[[dict], None]] = None,
) -> torch.nn.Module:
    """MLM over task sequences; returns the trained copy of the model.
    Reference semantics: 15% Bernoulli mask over ALL positions (PAD
    included, gue.py:321-323), CE summed over non-PAD targets / non-PAD
    count / accum steps (gue.py:326); single-group AdamW + LinearLR; no
    dropout (gue.py never calls model.train() here)."""
    rng_np = np.random.default_rng(seed)
    num_steps = int(num_epochs * len(tokenized) /
                    (batch_size * num_accumulation_steps))
    model = finetune_copy(model, cfg)
    opt, sched = adamw([list(model.parameters())], [linear_to_zero(lr, num_steps)])

    for step in range(num_steps):
        total = 0.0
        for _ in range(num_accumulation_steps):
            idx = rng_np.choice(len(tokenized), min(batch_size, len(tokenized)),
                                replace=False)  # small splits must not crash
            x, seg = pad_batch([tokenized[i] for i in idx], bucket, max_len)
            mask = rng_np.random(x.shape) < 0.15
            masked = np.where(mask, MASK_TOKEN, x)
            loss = mlm_nonpad_loss(model, *to_device(model, x, seg, masked))
            (loss / num_accumulation_steps).backward()
            total = total + loss.detach() / num_accumulation_steps
        step_optimizer(opt, sched)
        if log:
            log({"phase": "domain_mlm", "step": step, "loss": float(total)})
    return model


# --------------------------------------------------------------------------
# Sequence-classification fine-tune (gue.py:50-260)
# --------------------------------------------------------------------------

def classify_logits(model, head, tokens, segments, *, pool: str = "first",
                    deterministic: bool = True, rng: Optional[int] = None):
    """Head logits of the pooled embeddings (first token or mean over every
    position), in the compute dtype."""
    emb = model(tokens, segments, deterministic=deterministic, rng=rng,
                return_embeddings=True)
    pooled = emb[:, 0] if pool == "first" else emb.mean(dim=1)
    return apply_linear_head(head, pooled)


def classifier_loss(model, head, tokens, segments, labels, *,
                    deterministic: bool, rng: Optional[int] = None):
    """Mean CE of the first-token logits (fp32)."""
    logits = classify_logits(model, head, tokens, segments,
                             deterministic=deterministic, rng=rng).float()
    return F.cross_entropy(logits, labels.long())


def _predict_classes(model, head, cfg, tokenized, batch_size, bucket,
                     max_len, pool: str = "first"):
    """Argmax classes, one inference forward a batch."""
    model.eval()
    preds = []
    with torch.inference_mode():
        for i in range(0, len(tokenized), batch_size):
            x, seg = pad_batch(tokenized[i:i + batch_size], bucket, max_len)
            logits = classify_logits(model, head, *to_device(model, x, seg), pool=pool)
            preds += logits.argmax(-1).cpu().tolist()
    return preds


def finetune_classifier(
    model: torch.nn.Module,
    cfg: OmniBioTAConfig,
    data: Dict[str, Tuple[List[List[int]], np.ndarray]],  # train/val/test
    *,
    num_classes: int,
    num_epochs: int = 4,
    batch_size: int = 4,
    num_accumulation_steps: int = 8,
    lr: float = 1e-4,
    embed_lr: float = 1e-2,
    head_lr: float = 1e-2,
    test_freq: int = 100,
    seed: int = 0,
    bucket: int = 128,
    max_len: Optional[int] = None,
    metric_fn: Optional[Callable] = None,
    log: Optional[Callable[[dict], None]] = None,
) -> Tuple[float, float, dict]:
    """Returns (primary_metric, secondary_metric, aux) on test, evaluated
    with the best-on-val model (gue.py:219-260). metric_fn(y_true, y_pred)
    -> (primary, secondary); defaults to (MCC, weighted F1). aux holds the
    last model's test metrics, the best val metric, the best model and head
    ("params": {"model", "head"}) and how many best-on-val snapshots were
    taken (each a copy of every parameter)."""
    if metric_fn is None:
        metric_fn = lambda yt, yp: (
            matthews_corrcoef(yt, yp), f1_score(yt, yp, average="weighted"))

    X_train, Y_train = data["train"]
    X_val, Y_val = data["val"]
    X_test, Y_test = data["test"]

    rng_np = np.random.default_rng(seed)
    model = finetune_copy(model, cfg)  # fresh copy per task
    dev = next(model.parameters()).device
    head = init_linear_head(torch.Generator().manual_seed(seed), cfg.n_embd,
                            num_classes, device=dev)

    num_steps = max(1, int(num_epochs * len(X_train) /
                           (batch_size * num_accumulation_steps)))
    opt, sched = make_finetune_optimizer(
        model, head, lr=lr, embed_lr=embed_lr, head_lr=head_lr,
        total_steps=num_steps)
    live = trainable(model, head)
    deterministic = cfg.dropout == 0.0

    best_val = -np.inf
    best = None
    n_snapshots = 0
    val_every = max(1, num_steps // test_freq)

    for step in range(num_steps):
        if step % val_every == 0:
            preds = _predict_classes(model, head, cfg, X_val, batch_size,
                                     bucket, max_len)
            vm, vf = metric_fn(Y_val[:len(preds)], preds)
            if vm > best_val:
                best_val = vm
                best = snapshot(live, best)
                n_snapshots += 1
            if log:
                log({"phase": "finetune", "step": step, "val_primary": vm,
                     "val_secondary": vf})

        model.train()
        total = 0.0
        for micro in range(num_accumulation_steps):
            idx = rng_np.choice(len(X_train), min(batch_size, len(X_train)),
                                replace=False)  # small splits must not crash
            x, seg = pad_batch([X_train[i] for i in idx], bucket, max_len)
            y = Y_train[idx].astype(np.int64)
            loss = classifier_loss(model, head, *to_device(model, x, seg, y),
                                   deterministic=deterministic,
                                   rng=slot_seed(seed, step, micro))
            (loss / num_accumulation_steps).backward()
            total = total + loss.detach() / num_accumulation_steps
        step_optimizer(opt, sched)
        if log:
            log({"phase": "finetune", "step": step, "loss": float(total)})

    # last-model test (reported by the reference, gue.py:215-217)
    preds_last = _predict_classes(model, head, cfg, X_test, batch_size,
                                  bucket, max_len)
    last_metrics = metric_fn(Y_test[:len(preds_last)], preds_last)

    # best-on-val model test — the returned result (gue.py:219-260)
    if best is not None:
        restore(live, best)
        del best
    preds_best = _predict_classes(model, head, cfg, X_test, batch_size,
                                  bucket, max_len)
    best_metrics = metric_fn(Y_test[:len(preds_best)], preds_best)

    aux = {"last_test": last_metrics, "best_val": best_val,
           "params": {"model": model, "head": head},
           "snapshots": n_snapshots}
    return best_metrics[0], best_metrics[1], aux
