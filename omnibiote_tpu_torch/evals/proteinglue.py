"""ProteinGLUE benchmark suite, PyTorch port of
`omnibiote_tpu/evals/proteinglue.py`.

The reference's evals/proteinGLUE.py protocol: 8 per-residue tasks —
SS3, SS8 (+ CB513 test-only variants), BUR, ASA, PPI, EPI, HPR. Raw CSVs are
cleaned and cached to ProteinGLUE_processed.pkl (:24-93); char labels map to
BPE tokens by mode (classification) or mean (regression); ASA/HPR are
min-max normalised with train statistics; metrics ACC / PCC / AUC; results
CSV ProteinGLUE_{suffix}_results.csv.

Usage:
  python -m omnibiote_tpu_torch.evals.proteinglue --sp_dir .../mixed_bpe.model \
      --model_dir checkpoints/omnibiota --eval_dir datasets/ProteinGLUE [--device cpu]
"""
from __future__ import annotations

import argparse
import csv
import os
import pickle
import re
from typing import Dict, List

import numpy as np
from scipy.stats import pearsonr

from ..tokenizer import SentencePieceProcessor
from ..training.checkpoint import load_model_checkpoint
from .alignment import (
    align_labels_mode, align_labels_mean, minmax_normalizer, process_split)
from .engine import domain_mlm_pretrain
from .metrics import accuracy_score, roc_auc_score
from .token_finetune import finetune_token_task, evaluate_token_task


# --------------------------------------------------------------------------
# Dataset cleaning (proteinGLUE.py:24-93)
# --------------------------------------------------------------------------

def _read_csv_columns(path: str) -> Dict[str, List[str]]:
    """{column: cells as strings} of a CSV with a header row, as a pandas
    reading hands them to the cleaning below (an empty cell reads 'nan')."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {col: [(row[j] if j < len(row) and row[j] != "" else "nan")
                  for row in body]
            for j, col in enumerate(header)}


def get_cleaned_evals(eval_dir: str, cache_path: str = None, force=False):
    cache_path = cache_path or os.path.join(
        os.path.dirname(eval_dir) or ".", "ProteinGLUE_processed.pkl")
    if os.path.isfile(cache_path) and not force:
        with open(cache_path, "rb") as f:
            return pickle.load(f)

    datasets: Dict[str, dict] = {}
    for fn in sorted(os.listdir(eval_dir)):
        if "csv" not in fn:
            continue
        df = {col: [re.sub(r"[\[\]\'b\n]", "", x) for x in cells]
              for col, cells in _read_csv_columns(os.path.join(eval_dir, fn)).items()}
        name = fn[:-4]
        datasets[name] = {"sequences": []}
        label_columns = [c for c in df if c != "sequence"]
        error_indices = set()
        for col in label_columns:
            labels = []
            for i, raw in enumerate(df[col]):
                if "..." in raw.split():
                    error_indices.add(i)
                    continue
                labels.append([float(v) for v in raw.split()])
            datasets[name][col] = labels
        for i, seq in enumerate(df["sequence"]):
            if i not in error_indices:
                datasets[name]["sequences"].append(seq)
    with open(cache_path, "wb") as f:
        pickle.dump(datasets, f)
    return datasets


# task -> (dataset prefix, label column) (proteinGLUE.py:96-161)
TASK_SOURCES = {
    "SS3": ("ss", "ss3"),
    "SS8": ("ss", "ss8"),
    "CB513SS3": ("ss_cb513", "ss3"),
    "CB513SS8": ("ss_cb513", "ss8"),
    "BUR": ("asabu", "buried"),
    "ASA": ("asabu", "solvent_accessibility"),
    "PPI": ("ppi_hetro_homo", "interface"),
    "EPI": ("Epitope_anti", "interface"),
    "HPR": ("HPrank", "hydrophobic_patch"),
}

# split-name suffixes per dataset family
SPLIT_NAMES = {
    "ss": ("ss_training", "ss_validation", "ss_test"),
    "ss_cb513": (None, None, "ss_cb513_test"),
    "asabu": ("asabu_training", "asabu_validation", "asabu_test"),
    "ppi_hetro_homo": ("ppi_hetro_homo_training", "ppi_hetro_homo_validation",
                       "ppi_hetro_homo_test"),
    "Epitope_anti": ("Epitope_anti_training_1", "Epitope_anti_validation_1",
                     "Epitope_anti_test_1"),
    "HPrank": ("HPrank_training", "HPrank_validation", "HPrank_test"),
}

# metric / loss / alignment per task (proteinGLUE.py:604-634)
TASK_SPECS = {
    "SS3": ("ACC", "cross_entropy", align_labels_mode),
    "SS8": ("ACC", "cross_entropy", align_labels_mode),
    "CB513SS3": ("ACC", "cross_entropy", align_labels_mode),
    "CB513SS8": ("ACC", "cross_entropy", align_labels_mode),
    "BUR": ("ACC", "cross_entropy", align_labels_mode),
    "ASA": ("PCC", "mse", align_labels_mean),
    "PPI": ("AUC", "cross_entropy", align_labels_mode),
    "EPI": ("AUC", "cross_entropy", align_labels_mode),
    "HPR": ("PCC", "mse", align_labels_mean),
}


def metric_function(metric: str):
    if metric == "PCC":
        return lambda y, p: pearsonr(np.asarray(y, np.float64),
                                     np.asarray(p, np.float64))[0]
    if metric == "ACC":
        return accuracy_score
    if metric == "AUC":
        return roc_auc_score
    raise ValueError(metric)


def load_task(task: str, datasets: dict):
    family, col = TASK_SOURCES[task]
    tr, va, te = SPLIT_NAMES[family]
    def get(split):
        if split is None:
            return None, None
        return datasets[split]["sequences"], datasets[split][col]
    return (*get(tr), *get(va), *get(te))


def get_training_sets(task, datasets, sp, align_fn, prefix, banned):
    Xtr_raw, ytr_raw, Xv_raw, yv_raw, Xte_raw, yte_raw = load_task(
        task, datasets)
    if task not in ("CB513SS3", "CB513SS8"):
        X_train, y_train = process_split(sp, Xtr_raw, ytr_raw, align_fn,
                                         prefix, banned)
        X_val, y_val = process_split(sp, Xv_raw, yv_raw, align_fn, prefix,
                                     banned)
    else:
        X_train = y_train = X_val = y_val = None
    X_test, y_test = process_split(sp, Xte_raw, yte_raw, align_fn, prefix,
                                   banned)
    if task in ("ASA", "HPR"):
        norm = minmax_normalizer(ytr_raw)  # fit on RAW train labels (:311)
        y_train = norm(y_train)
        y_val = norm(y_val)
        y_test = norm(y_test)
    return X_train, y_train, X_val, y_val, X_test, y_test


def run_proteinglue(
    sp_dir: str,
    model_dir: str,
    banned_token=65533,
    eval_dir: str = "../datasets/ProteinGLUE",
    extra_pretrain: bool = False,
    pretraining_epochs: int = 4,
    pretraining_num_accum_steps: int = 4,
    batch_size: int = 32,
    pretraining_lr: float = 1e-3,
    finetuning_lr: float = 2e-4,
    output_suffix: str = "",
    tasks: List[str] = ("SS3", "SS8", "ASA", "HPR", "PPI", "BUR", "EPI"),
    num_epochs: int = 0,   # 0 = reference per-task table
    seed: int = 0,
    train_backbone: bool = False,
    force_clean: bool = False,
    log=None,
    device=None,
):
    """Fine-tunes and tests each task (the CB513 subtests on the SS3/SS8
    heads); writes ProteinGLUE_{output_suffix}_results.csv in the working
    directory. device: None (the GPU) or e.g. "cpu"."""
    sp = SentencePieceProcessor(sp_dir)
    banned = banned_token if isinstance(banned_token, list) else [banned_token]
    model, cfg = load_model_checkpoint(model_dir, device=device)
    datasets = get_cleaned_evals(eval_dir, force=force_clean)
    prefix = [t for t in sp.encode("<protein>") if t not in banned]

    # one tokenize+align pass per task: the per-token sp.decode alignment
    # dominates the suite's CPU time, and extra_pretrain + the main loop +
    # the CB513 subtests would otherwise each redo it (r4 review)
    _sets_cache = {}

    def sets(task, align_fn):
        if task not in _sets_cache:
            _sets_cache[task] = get_training_sets(
                task, datasets, sp, align_fn, prefix, banned)
        return _sets_cache[task]

    if extra_pretrain:
        all_seqs = []
        for task in tasks:
            all_seqs += sets(task, TASK_SPECS[task][2])[0]
        model = domain_mlm_pretrain(
            model, cfg, all_seqs, num_epochs=pretraining_epochs,
            batch_size=batch_size,
            num_accumulation_steps=pretraining_num_accum_steps,
            lr=pretraining_lr, seed=seed, max_len=cfg.block_size, log=log)

    results = {}
    for task in tasks:
        metric, loss_str, align_fn = TASK_SPECS[task]
        X_train, y_train, X_val, y_val, X_test, y_test = sets(task, align_fn)
        epochs = num_epochs or (16 if task in ("EPI", "PPI") else 64)
        model_p, head, _ = finetune_token_task(
            model, cfg, {"train": (X_train, y_train), "val": (X_val, y_val)},
            loss_str=loss_str, metric_fn=metric_function(metric),
            num_epochs=epochs, batch_size=batch_size,
            num_accumulation_steps=1, lr=finetuning_lr, embed_lr=1e-2,
            seed=seed, train_backbone=train_backbone, log=log)
        results[task] = evaluate_token_task(
            model_p, head, cfg, X_test, y_test,
            metric_fn=metric_function(metric), is_mse=loss_str == "mse",
            batch_size=batch_size)
        print(f"{task}: {metric} {results[task]:.4f}")
        # CB513 subtests ride the SS3/SS8 heads (proteinGLUE.py:649-658)
        for base, sub in (("SS3", "CB513SS3"), ("SS8", "CB513SS8")):
            if task == base:
                _, _, _, _, X_cb, y_cb = sets(sub, align_fn)
                results[sub] = evaluate_token_task(
                    model_p, head, cfg, X_cb, y_cb,
                    metric_fn=metric_function(metric),
                    batch_size=batch_size)
                print(f"{sub}: {metric} {results[sub]:.4f}")

    with open(f"ProteinGLUE_{output_suffix}_results.csv", "w") as f:
        for t, r in results.items():
            f.write(f"{t},{r}\n")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="ProteinGLUE eval")
    ap.add_argument("--sp_dir", required=True)
    ap.add_argument("--model_dir", required=True)
    ap.add_argument("--banned_token", type=int, default=65533)
    ap.add_argument("--eval_dir", default="../datasets/ProteinGLUE")
    ap.add_argument("--extra_pretrain", action="store_true")
    ap.add_argument("--pretraining_epochs", type=int, default=4)
    ap.add_argument("--pretraining_num_accum_steps", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--pretraining_lr", type=float, default=1e-3)
    ap.add_argument("--finetuning_lr", type=float, default=2e-4)
    ap.add_argument("--output_suffix", default="")
    ap.add_argument("--num_epochs", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train_backbone", action="store_true")
    ap.add_argument("--force_clean", action="store_true")
    ap.add_argument("--tasks", nargs="+",
                    default=["SS3", "SS8", "ASA", "HPR", "PPI", "BUR", "EPI"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    a = ap.parse_args(argv)
    return run_proteinglue(**vars(a))


if __name__ == "__main__":
    main()
