"""TAPE benchmark suite, PyTorch port of `omnibiote_tpu/evals/tape.py`.

The reference's evals/TAPE/TAPE.py protocol: tasks structure_ss3/ss8
(tested on casp12/cb513/ts115), remote_homology (3 holdout test sets, 1195
classes), fluorescence and stability (z-scored regression, Spearman).
Inputs are <protein>-prefixed token sequences; token tasks read
embeddings[:, 1:len(y)+1], sequence tasks embeddings[:, 0]; best-on-val
model is used for the subtests; results to TAPE_{suffix}_results.csv.

Usage:
  python -m omnibiote_tpu_torch.evals.tape --sp_dir .../mixed_bpe.model \
      --model_dir checkpoints/omnibiota --tape_dir datasets/TAPE/data [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List

from scipy.stats import spearmanr

from ..tokenizer import SentencePieceProcessor
from ..training.checkpoint import load_model_checkpoint
from .alignment import (
    align_labels_mode, align_single, process_split, zscore_normalizer)
from .metrics import accuracy_score
from .token_finetune import finetune_token_task, evaluate_token_task


# --------------------------------------------------------------------------
# Loaders (TAPE.py:23-99)
# --------------------------------------------------------------------------

def load_secondary_structure(split, base_dir):
    with open(os.path.join(
            base_dir, f"secondary_structure/secondary_structure_{split}.json")) as f:
        data = json.load(f)
    seqs = [d["primary"] for d in data]
    return seqs, [d["ss3"] for d in data], [d["ss8"] for d in data]


def load_remote_homology(split, base_dir):
    with open(os.path.join(
            base_dir, f"remote_homology/remote_homology_{split}.json")) as f:
        data = json.load(f)
    return ([d["primary"] for d in data], [d["fold_label"] for d in data])


def load_scalar_task(name, split, base_dir, key):
    with open(os.path.join(base_dir, f"{name}/{name}_{split}.json")) as f:
        data = json.load(f)
    seqs, vals = [], []
    for d in data:
        seqs.append(d["primary"])
        v = d[key]
        vals.append(v[0] if isinstance(v, list) else v)
    return seqs, vals


# --------------------------------------------------------------------------
# Task table (TAPE.py:636-679)
# --------------------------------------------------------------------------

SS_TESTS = {"ss3": ["casp12_ss3", "cb513_ss3", "ts115_ss3"],
            "ss8": ["casp12_ss8", "cb513_ss8", "ts115_ss8"]}

RH_TESTS = ["remote_homology_test_fold_holdout",
            "remote_homology_test_family_holdout",
            "remote_homology_test_superfamily_holdout"]


def spearman_metric(y, pred):
    return spearmanr(y, pred)[0]


def run_tape(
    sp_dir: str,
    model_dir: str,
    banned_token=65533,
    tape_dir: str = "../datasets/TAPE/data",
    finetuning_lr: float = 2e-4,
    output_suffix: str = "",
    tasks: List[str] = ("structure_ss3", "structure_ss8", "remote_homology",
                        "fluorescence", "stability"),
    num_epochs: int = 64,
    batch_size: int = 32,
    seed: int = 0,
    train_backbone: bool = False,
    log=None,
    device=None,
):
    """Fine-tunes and tests each task; writes TAPE_{output_suffix}_results.csv
    in the working directory. device: None (the GPU) or e.g. "cpu"."""
    sp = SentencePieceProcessor(sp_dir)
    banned = banned_token if isinstance(banned_token, list) else [banned_token]
    model, cfg = load_model_checkpoint(model_dir, device=device)
    prefix = [t for t in sp.encode("<protein>") if t not in banned]

    results = {}
    for task in tasks:
        if "ss3" in task or "ss8" in task:
            key = "ss3" if "ss3" in task else "ss8"
            seqs, ss3, ss8 = load_secondary_structure("train", tape_dir)
            y_tr = ss3 if key == "ss3" else ss8
            vseqs, vss3, vss8 = load_secondary_structure("valid", tape_dir)
            y_v = vss3 if key == "ss3" else vss8
            X_train, Y_train = process_split(
                sp, seqs, y_tr, align_labels_mode, prefix, banned)
            X_val, Y_val = process_split(
                sp, vseqs, y_v, align_labels_mode, prefix, banned)
            model_p, head, info = finetune_token_task(
                model, cfg,
                {"train": (X_train, Y_train), "val": (X_val, Y_val)},
                loss_str="cross_entropy", metric_fn=accuracy_score,
                num_epochs=num_epochs, batch_size=batch_size,
                lr=finetuning_lr, embed_lr=1e-3, seed=seed,
                train_backbone=train_backbone, log=log)
            for sub in SS_TESTS[key]:
                split = sub.split("_")[0]
                tseqs, tss3, tss8 = load_secondary_structure(split, tape_dir)
                y_t = tss3 if key == "ss3" else tss8
                X_test, Y_test = process_split(
                    sp, tseqs, y_t, align_labels_mode, prefix, banned)
                results[sub] = evaluate_token_task(
                    model_p, head, cfg, X_test, Y_test,
                    metric_fn=accuracy_score, batch_size=batch_size)
                print(f"{sub}: ACC {results[sub]:.4f}")

        elif task == "remote_homology":
            seqs, y = load_remote_homology("train", tape_dir)
            vseqs, vy = load_remote_homology("valid", tape_dir)
            X_train, Y_train = process_split(
                sp, seqs, y, align_single, prefix, banned)
            X_val, Y_val = process_split(
                sp, vseqs, vy, align_single, prefix, banned)
            model_p, head, info = finetune_token_task(
                model, cfg,
                {"train": (X_train, Y_train), "val": (X_val, Y_val)},
                loss_str="cross_entropy", metric_fn=accuracy_score,
                single_target=True, num_epochs=num_epochs,
                batch_size=batch_size, lr=finetuning_lr, embed_lr=1e-3,
                seed=seed, train_backbone=train_backbone, log=log)
            for sub in RH_TESTS:
                split = sub.replace("remote_homology_", "")
                tseqs, ty = load_remote_homology(split, tape_dir)
                X_test, Y_test = process_split(
                    sp, tseqs, ty, align_single, prefix, banned)
                results[sub] = evaluate_token_task(
                    model_p, head, cfg, X_test, Y_test,
                    metric_fn=accuracy_score, single_target=True,
                    batch_size=batch_size)
                print(f"{sub}: ACC {results[sub]:.4f}")

        elif task in ("fluorescence", "stability"):
            key = ("log_fluorescence" if task == "fluorescence"
                   else "stability_score")
            seqs, y = load_scalar_task(task, "train", tape_dir, key)
            vseqs, vy = load_scalar_task(task, "valid", tape_dir, key)
            tseqs, ty = load_scalar_task(task, "test", tape_dir, key)
            norm = zscore_normalizer(y)
            y, vy, ty = norm(y), norm(vy), norm(ty)
            X_train, Y_train = process_split(
                sp, seqs, y, align_single, prefix, banned)
            X_val, Y_val = process_split(
                sp, vseqs, vy, align_single, prefix, banned)
            X_test, Y_test = process_split(
                sp, tseqs, ty, align_single, prefix, banned)
            model_p, head, info = finetune_token_task(
                model, cfg,
                {"train": (X_train, Y_train), "val": (X_val, Y_val)},
                loss_str="mse", metric_fn=spearman_metric,
                single_target=True, num_epochs=num_epochs,
                batch_size=batch_size, lr=finetuning_lr, embed_lr=1e-3,
                seed=seed, train_backbone=train_backbone, log=log)
            results[task] = evaluate_token_task(
                model_p, head, cfg, X_test, Y_test,
                metric_fn=spearman_metric, single_target=True, is_mse=True,
                batch_size=batch_size)
            print(f"{task}: SCC {results[task]:.4f}")
        else:
            raise ValueError(f"Unknown task {task}")

    with open(f"TAPE_{output_suffix}_results.csv", "w") as f:
        for t, r in results.items():
            f.write(f"{t},{r}\n")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="TAPE eval")
    ap.add_argument("--sp_dir", required=True)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--banned_token", type=int, default=65533)
    ap.add_argument("--tape_dir", default="../datasets/TAPE/data")
    ap.add_argument("--finetuning_lr", type=float, default=2e-4)
    ap.add_argument("--output_suffix", default="")
    ap.add_argument("--num_epochs", type=int, default=64)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train_backbone", action="store_true")
    ap.add_argument("--tasks", nargs="+",
                    default=["structure_ss3", "structure_ss8",
                             "remote_homology", "fluorescence", "stability"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    a = ap.parse_args(argv)
    return run_tape(**vars(a))


if __name__ == "__main__":
    main()
