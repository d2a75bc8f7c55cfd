"""GUE benchmark (DNA classification tasks), PyTorch port of
`omnibiote_tpu/evals/gue.py`.

The reference's evals/gue.py protocol: per-task CSVs
(train/dev/test with sequence,label columns), phase 1 = domain-adaptive MLM
over all task train sequences, phase 2 = per-task fine-tune with a fresh
linear head on the first-token embedding, 3 LR groups + OneCycleLR, per-task
epoch table (gue.py:339-357), best-on-val-MCC selection, test MCC + weighted
F1 written to GUE_results_{suffix}.csv.

Usage:
  python -m omnibiote_tpu_torch.evals.gue --sp_dir .../mixed_bpe.model \
      --model_dir checkpoints/omnibiota --banned_token 65533 \
      --gue_dir datasets/GUE [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import List

import numpy as np

from ..tokenizer import SentencePieceProcessor
from ..training.checkpoint import load_model_checkpoint
from .common import tokenize_sequences
from .engine import domain_mlm_pretrain, finetune_classifier


def load_task(task_dir: str):
    """train/dev/test CSVs -> (X, Y) lists (reference load_task, gue.py:23-48)."""
    def read(name):
        X, Y = [], []
        with open(os.path.join(task_dir, name)) as f:
            for line in f.readlines()[1:]:
                parts = line.split(",")
                X.append(parts[0])
                Y.append(parts[1])
        return X, Y

    X_train, Y_train = read("train.csv")
    X_val, Y_val = read("dev.csv")
    X_test, Y_test = read("test.csv")
    return X_train, Y_train, X_val, Y_val, X_test, Y_test


def epochs_for_task(task: str) -> int:
    """Per-task epoch table (gue.py:339-357)."""
    if "EMP" in task:
        return 32
    if "mouse" in task:
        return 100
    for key in ("covid", "tata", "notata", "all", "splice", "tf"):
        if key in task:
            return 32
    raise ValueError("Unknown task")


def list_tasks(gue_dir: str) -> List[str]:
    subs = [os.path.join(gue_dir, d) for d in os.listdir(gue_dir)
            if os.path.isdir(os.path.join(gue_dir, d))]
    return [os.path.join(s, t) for s in subs for t in sorted(os.listdir(s))]


def run_gue(
    sp_dir: str,
    model_dir: str,
    banned_token: int,
    gue_dir: str = "../datasets/GUE",
    pretraining_epochs: int = 4,
    pretraining_num_accum_steps: int = 4,
    batch_size: int = 32,
    pretraining_lr: float = 1e-3,
    finetuning_lr: float = 1e-3,
    output_suffix: str = "",
    max_tasks: int = 0,
    seed: int = 0,
    log=None,
    device=None,
):
    """Domain MLM over every task's train sequences, then a fine-tune per
    task; writes GUE_results_{output_suffix}.csv (Task,MCC,F1) in the
    working directory. device: None (the GPU) or e.g. "cpu"."""
    sp = SentencePieceProcessor(sp_dir)
    banned = [banned_token]
    model, cfg = load_model_checkpoint(model_dir, device=device)
    tasks = list_tasks(gue_dir)
    if max_tasks:
        tasks = tasks[:max_tasks]

    # phase 1: domain-adaptive MLM over every task's train sequences
    all_sequences: List[str] = []
    for task in tasks:
        all_sequences += load_task(task)[0]
    tokenized = tokenize_sequences(sp, all_sequences, tag="<DNA>",
                                   banned_tokens=banned)
    model = domain_mlm_pretrain(
        model, cfg, tokenized, num_epochs=pretraining_epochs,
        batch_size=batch_size,
        num_accumulation_steps=pretraining_num_accum_steps,
        lr=pretraining_lr, seed=seed, max_len=cfg.block_size, log=log)

    # phase 2: per-task fine-tune
    results = {}
    for task in tasks:
        X_train, Y_train, X_val, Y_val, X_test, Y_test = load_task(task)
        data = {
            "train": (tokenize_sequences(sp, X_train, "<DNA>", banned),
                      np.asarray([int(y) for y in Y_train])),
            "val": (tokenize_sequences(sp, X_val, "<DNA>", banned),
                    np.asarray([int(y) for y in Y_val])),
            "test": (tokenize_sequences(sp, X_test, "<DNA>", banned),
                     np.asarray([int(y) for y in Y_test])),
        }
        n_classes = int(max(data["train"][1])) + 1
        mcc, f1, _ = finetune_classifier(
            model, cfg, data, num_classes=n_classes,
            num_epochs=epochs_for_task(task), batch_size=batch_size,
            num_accumulation_steps=pretraining_num_accum_steps,
            lr=finetuning_lr, embed_lr=1e-3, head_lr=1e-2,
            max_len=cfg.block_size, seed=seed, log=log)
        results[task] = {"mcc": mcc, "f1": f1}
        print(f"{task}: MCC {mcc*100:.2f}, F1 {f1*100:.2f}")

    out = f"GUE_results_{output_suffix}.csv"
    with open(out, "w") as f:
        f.write("Task,MCC,F1\n")
        for task, r in results.items():
            f.write(f"{task},{r['mcc']},{r['f1']}\n")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="GUE eval")
    ap.add_argument("--sp_dir", required=True)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--banned_token", type=int, required=True)
    ap.add_argument("--gue_dir", default="../datasets/GUE")
    ap.add_argument("--pretraining_epochs", type=int, default=4)
    ap.add_argument("--pretraining_num_accum_steps", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--pretraining_lr", type=float, default=1e-3)
    ap.add_argument("--finetuning_lr", type=float, default=1e-3)
    ap.add_argument("--output_suffix", default="")
    ap.add_argument("--max_tasks", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    a = ap.parse_args(argv)
    return run_gue(**vars(a))


if __name__ == "__main__":
    main()
