"""Token-level and single-target fine-tuning engine (TAPE / ProteinGLUE),
PyTorch port of `omnibiote_tpu/evals/token_finetune.py`.

Protocol (the reference's evals/TAPE/TAPE.py:429-626 and
evals/proteinGLUE.py:363-527, the same skeleton twice):
  * inputs are [prefix + tokens + EOS], truncated to 1024; token-level labels
    truncated to 1023; predictions read from embeddings[:, 1:len(y)+1]
    (token tasks) or embeddings[:, 0] (single-target tasks)
  * per-sample CE mean (or MSE), scaled by 1/(accum * batch)
  * AdamW + LinearLR-to-zero; periodic val; best-on-val snapshot; test with
    the best snapshot

Faithfulness note: in both reference files the optimizer's parameter groups
come from a deepcopy of the model while every forward runs through the
original, so only the head trains and the "best model" is the unmodified
backbone. That is the default here (train_backbone=False): the backbone
runs without dropout and without an autograd graph, as a frozen feature
extractor, and an AdamW over the head alone steps. train_backbone=True is
the repaired full fine-tune with the reference's three LR groups and a
linear schedule.

Samples are batched with PAD and padding masks (the reference forwards one
unmasked sample at a time), which gives real positions the same embeddings,
bucketed to bounded shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import OmniBioTAConfig
from ..training.train import slot_seed
from .common import (
    adamw, apply_linear_head, finetune_copy, init_linear_head, linear_to_zero,
    make_finetune_optimizer, pad_batch, restore, snapshot, step_optimizer,
    to_device, trainable)

MAX_TOKENS = 1024   # x[:1024] (TAPE.py:482)
MAX_LABELS = 1023   # y[:1023] (TAPE.py:485)


def _batched_embeddings(model, cfg, token_lists, batch_size, bucket):
    """Eval-mode embeddings for a list of token sequences: a list of fp32
    numpy arrays (len_i, D) for positions 0..len_i-1."""
    model.eval()
    out = []
    with torch.inference_mode():
        for i in range(0, len(token_lists), batch_size):
            chunk = [t[:MAX_TOKENS] for t in token_lists[i:i + batch_size]]
            x, seg = pad_batch(chunk, bucket, MAX_TOKENS)
            emb = model(*to_device(model, x, seg), return_embeddings=True)
            emb = emb.float().cpu().numpy()
            for j, toks in enumerate(chunk):
                out.append(emb[j, :len(toks)])
    return out


def _predict(head, emb_list, Y, single_target, is_mse):
    """Flattened (ground_truths, predictions) over a split
    (TAPE.py:585-623)."""
    gts, preds = [], []
    w = head["w"].detach().float().cpu().numpy()
    b = head["b"].detach().float().cpu().numpy()
    for emb, y in zip(emb_list, Y):
        if single_target:
            out = emb[0] @ w + b
            gts.append(float(y) if is_mse else int(y))
            preds.append(float(out[0]) if is_mse else int(np.argmax(out)))
        else:
            y = np.asarray(y)[:MAX_LABELS]
            sl = emb[1:len(y) + 1]
            out = sl @ w + b
            gts.extend(y.tolist())
            if is_mse:
                preds.extend(out.reshape(-1).tolist())
            else:
                preds.extend(np.argmax(out, -1).tolist())
    return np.asarray(gts), np.asarray(preds)


def token_loss(model, head, tokens, segments, labels, label_mask, *,
               single_target: bool, is_mse: bool, train_backbone: bool,
               deterministic: bool, rng: Optional[int] = None):
    """The task loss of one micro-batch: per-sample CE or squared error on
    the first token (single target), else the label-masked per-token mean
    of each sample; then the mean over samples. With a frozen backbone its
    forward builds no autograd graph."""
    with torch.set_grad_enabled(train_backbone and torch.is_grad_enabled()):
        emb = model(tokens, segments, deterministic=deterministic, rng=rng,
                    return_embeddings=True)
    if single_target:
        out = apply_linear_head(head, emb[:, 0]).float()
        if is_mse:
            per = (out[:, 0] - labels) ** 2
        else:
            per = F.cross_entropy(out, labels.long(), reduction="none")
        return per.sum() / per.shape[0]
    out = apply_linear_head(head, emb[:, 1:]).float()
    if is_mse:
        per = (out[..., 0] - labels) ** 2
    else:
        per = F.cross_entropy(out.transpose(1, 2), labels.long(), reduction="none")
    per = torch.where(label_mask, per, 0.0)
    per_seq = per.sum(-1) / label_mask.sum(-1).clamp_min(1)
    return per_seq.sum() / per_seq.shape[0]


def finetune_token_task(
    model: torch.nn.Module,
    cfg: OmniBioTAConfig,
    data: Dict[str, Tuple[List[List[int]], list]],   # train/val[/test]
    *,
    loss_str: str,                # 'mse' | 'cross_entropy'
    metric_fn: Callable,          # (y_true, y_pred) -> float
    single_target: bool = False,
    num_epochs: int = 64,
    batch_size: int = 32,
    num_accumulation_steps: int = 1,
    lr: float = 2e-4,
    embed_lr: float = 1e-3,
    head_lr: float = 1e-2,
    test_freq: int = 100,
    seed: int = 0,
    bucket: int = 128,
    train_backbone: bool = False,
    log: Optional[Callable[[dict], None]] = None,
):
    """Returns (best model, best head, history). Test evaluation is done
    separately by evaluate_token_task (the reference tests per subtest).
    With a frozen backbone the returned model is the one passed in."""
    X_train, Y_train = data["train"]
    X_val, Y_val = data["val"]
    is_mse = loss_str == "mse"

    rng_np = np.random.default_rng(seed)
    if single_target:
        out_dim = 1 if is_mse else int(max(Y_train)) + 1
    else:
        out_dim = 1 if is_mse else int(
            max(v for row in Y_train for v in row)) + 1
    dev = next(model.parameters()).device
    head = init_linear_head(torch.Generator().manual_seed(seed), cfg.n_embd,
                            out_dim, device=dev)

    num_steps = max(1, int(num_epochs * len(X_train) /
                           (batch_size * num_accumulation_steps)))

    if train_backbone:
        model = finetune_copy(model, cfg)
        opt, sched = make_finetune_optimizer(
            model, head, lr=lr, embed_lr=embed_lr, head_lr=head_lr,
            total_steps=num_steps, schedule="linear")
        live = trainable(model, head)
    else:
        opt, sched = adamw([list(head.values())],
                           [linear_to_zero(head_lr, num_steps)])
        live = head
    deterministic = (not train_backbone) or cfg.dropout == 0.0

    def stage(idx):
        toks = [X_train[i][:MAX_TOKENS] for i in idx]
        x, seg = pad_batch(toks, bucket, MAX_TOKENS)
        L = x.shape[1]
        if single_target:
            labels = np.asarray([Y_train[i] for i in idx],
                                np.float32 if is_mse else np.int64)
            lmask = np.ones((len(idx), 1), bool)
        else:
            labels = np.zeros((len(idx), L - 1),
                              np.float32 if is_mse else np.int64)
            lmask = np.zeros((len(idx), L - 1), bool)
            for j, i in enumerate(idx):
                y = np.asarray(Y_train[i])[:MAX_LABELS]
                y = y[:L - 1]
                labels[j, :len(y)] = y
                lmask[j, :len(y)] = True
        return to_device(model, x, seg, labels, lmask)

    best_metric = -np.inf
    best = None
    history = []
    val_every = max(1, num_steps // test_freq)

    # Frozen backbone: the validation embeddings never change, so they are
    # computed once, and a snapshot holds the head alone.
    frozen_emb_val = (None if train_backbone else _batched_embeddings(
        model, cfg, X_val, batch_size, bucket))

    for step in range(num_steps):
        if step % val_every == 0:
            emb_val = (frozen_emb_val if frozen_emb_val is not None
                       else _batched_embeddings(model, cfg, X_val,
                                                batch_size, bucket))
            gts, preds = _predict(head, emb_val, Y_val, single_target, is_mse)
            m = metric_fn(gts, preds)
            history.append({"step": step, "val_metric": float(m)})
            if log:
                log(history[-1])
            if m > best_metric:
                best_metric = m
                best = snapshot(live, best)

        model.train(train_backbone)
        total = 0.0
        for micro in range(num_accumulation_steps):
            idx = rng_np.choice(len(X_train), min(batch_size, len(X_train)),
                                replace=False)  # small splits must not crash
            loss = token_loss(model, head, *stage(idx), single_target=single_target,
                              is_mse=is_mse, train_backbone=train_backbone,
                              deterministic=deterministic,
                              rng=slot_seed(seed, step, micro))
            (loss / num_accumulation_steps).backward()
            total = total + loss.detach() / num_accumulation_steps
        step_optimizer(opt, sched)
        if log:
            log({"step": step, "loss": float(total)})

    if best is not None:
        restore(live, best)
    model.eval()
    return model, head, {"best_val": best_metric, "history": history}


def evaluate_token_task(model, head, cfg, X_test, Y_test, *, metric_fn,
                        single_target=False, is_mse=False, batch_size=32,
                        bucket: int = 128) -> float:
    emb = _batched_embeddings(model, cfg, X_test, batch_size, bucket)
    gts, preds = _predict(head, emb, Y_test, single_target, is_mse)
    return float(metric_fn(gts, preds))
