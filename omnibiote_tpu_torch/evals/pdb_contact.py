"""PDB peptide–nucleotide contact prediction (cross-modal), PyTorch port of
`omnibiote_tpu/evals/pdb_contact.py`.

The reference's evals/PDB_contact_eval.py protocol: per-residue binary
contact labels (closest_nucleotide distance <= 8 A) from
peptide-nucleotide-distances.json; input ids
[18(<protein>)] + peptide + [3(EOS), 4(<DNA>)] + nucleotide + [3]; char->
token label MAX-pooling (:52-71) and token->char upsampling for eval
(:73-81); 10-fold per-peptide splits (:100-124); sigmoid linear head on the
protein token span, BCE; full-model fine-tune with OneCycleLR (3 LR groups);
ROC AUC per fold appended to pdb_contact_eval_{suffix}.jsonl.
"""
from __future__ import annotations

import argparse
import json
import random
from typing import List, Sequence

import numpy as np
import torch

from ..config import EOS_TOKEN
from ..tokenizer import SentencePieceProcessor
from ..training.checkpoint import load_model_checkpoint
from ..training.train import slot_seed
from .common import (
    apply_linear_head, finetune_copy, init_linear_head, make_finetune_optimizer,
    pad_batch, step_optimizer, to_device)
from .metrics import auc, roc_curve

MAX_LEN = 1024


def process_sequence(sp, peptide: str, nucleotide: str, distances,
                     banned_tokens: Sequence[int]):
    """(input ids, per-protein-token max-pooled labels, protein token count)
    (:52-71)."""
    banned = set(banned_tokens)
    pep_ids = [t for t in sp.encode(peptide) if t not in banned]
    token_lens = [len(sp.decode([t])) for t in pep_ids]
    labels = []
    ptr = 0
    dist = np.asarray(distances, np.float32)
    for L in token_lens:
        if L <= 0:
            raise ValueError(f"token of empty surface form in {peptide!r}")
        labels.append(float(np.max(dist[ptr:ptr + L])))
        ptr += L
    protein_len = len(pep_ids)
    nuc_ids = [t for t in sp.encode(nucleotide) if t not in banned]
    tokenized = [18] + pep_ids + [EOS_TOKEN, 4] + nuc_ids + [EOS_TOKEN]
    return tokenized, labels, protein_len


def unprocess_sequence(sp, tokenized: List[int], token_labels):
    """Token->char upsampling: repeat each token's label by its surface
    length (:73-81)."""
    labels = []
    for tok, lab in zip(tokenized, token_labels):
        labels += [float(lab)] * len(sp.decode([int(tok)]))
    return labels


def load_distance_data(path: str):
    with open(path) as f:
        data = json.load(f)
    peptides, nucleotides, labels = [], [], []
    for rec in data:
        pep = rec["peptide_sequences"][list(rec["peptide_sequences"])[0]]
        nuc = rec["nucleotide_sequences"][list(rec["nucleotide_sequences"])[0]]
        lab = (np.asarray(rec["closest_nucleotides"], np.float32) <= 8
               ).astype(np.float32)
        if len(pep) != len(lab):
            continue  # (:42-50)
        peptides.append(pep)
        nucleotides.append(nuc)
        labels.append(lab)
    return peptides, nucleotides, labels


def contact_loss(model, head, tokens, segments, labels, lmask, weights, *,
                 deterministic: bool, rng=None):
    """Per-sequence mean BCE of the sigmoid head over the label-masked
    protein tokens, weighted and summed."""
    emb = model(tokens, segments, deterministic=deterministic, rng=rng,
                return_embeddings=True)
    logit = apply_linear_head(head, emb[:, 1:]).float()[..., 0]
    p = torch.sigmoid(logit)
    eps = 1e-7
    bce = -(labels * torch.log(p + eps) + (1 - labels) * torch.log(1 - p + eps))
    bce = torch.where(lmask, bce, 0.0)
    per_seq = bce.sum(-1) / lmask.sum(-1).clamp_min(1)
    return (per_seq * weights).sum()


def run_pdb_contact(
    model_fn: str,
    name_suffix: str,
    tokenizer_fn: str,
    distances_json: str = "../datasets/peptide-nucleotide-distances.json",
    banned_tokens: Sequence[int] = (65533,),
    num_epochs: int = 32,
    num_accumulation_steps: int = 256,
    micro_batch: int = 16,
    lr: float = 5e-5,
    embed_lr: float = 1e-3,
    head_lr: float = 1e-2,
    folds: int = 10,
    seed: int = 0,
    stable_folds: bool = False,
    device=None,
):
    """stable_folds=False reproduces a reference defect faithfully
    (PDB_contact_eval.py:100-111): random.shuffle(data) runs INSIDE the
    fold loop with an advancing RNG, so 'i % folds == fold' indexes a
    different permutation per fold — the CV folds are not disjoint (a
    record can be tested in several folds or none, and appear in another
    fold's train set). stable_folds=True is the repaired protocol:
    each peptide's records are shuffled once, before the fold loop.
    Returns the folds' ROC AUCs and appends each fold to
    pdb_contact_eval_{name_suffix}.jsonl in the working directory.
    device: None (the GPU) or e.g. "cpu"."""
    random.seed(seed)
    np.random.seed(seed)
    rng_np = np.random.default_rng(seed)

    sp = SentencePieceProcessor(tokenizer_fn)
    banned = list(banned_tokens)
    model0, cfg = load_model_checkpoint(model_fn, device=device)
    dev = next(model0.parameters()).device

    peptides, nucleotides, labels = load_distance_data(distances_json)
    peptide_data = {}
    for p, n, l in zip(peptides, nucleotides, labels):
        peptide_data.setdefault(p, []).append((p, n, l))

    if stable_folds:
        for data in peptide_data.values():
            random.shuffle(data)  # once: folds partition a FIXED order

    results = []
    for fold in range(folds):
        X_train, Y_train, L_train = [], [], []
        X_test, Y_test, L_test = [], [], []
        for pep, data in peptide_data.items():
            if not stable_folds:
                random.shuffle(data)  # faithful: see docstring
            for i, (p, n, l) in enumerate(data):
                tok, tok_labels, plen = process_sequence(sp, p, n, l, banned)
                if len(tok) > MAX_LEN:
                    continue
                if i % folds == fold:
                    X_test.append(tok)
                    Y_test.append(l)       # char-level truth (:119)
                    L_test.append(plen)
                else:
                    X_train.append(tok)
                    Y_train.append(tok_labels)
                    L_train.append(plen)

        model = finetune_copy(model0, cfg)
        head = init_linear_head(torch.Generator().manual_seed(seed + fold),
                                cfg.n_embd, 1, device=dev)
        num_steps = max(1, int(num_epochs * len(X_train)
                               / num_accumulation_steps))
        opt, sched = make_finetune_optimizer(
            model, head, lr=lr, embed_lr=embed_lr, head_lr=head_lr,
            total_steps=num_steps, schedule="onecycle")

        def stage(idx):
            toks = [X_train[i][:MAX_LEN] for i in idx]
            x, seg = pad_batch(toks, 128, MAX_LEN)
            Lm = x.shape[1] - 1
            labs = np.zeros((len(idx), Lm), np.float32)
            lmask = np.zeros((len(idx), Lm), bool)
            for j, i in enumerate(idx):
                y = np.asarray(Y_train[i], np.float32)[:Lm]
                labs[j, :len(y)] = y
                lmask[j, :len(y)] = True
            return to_device(model, x, seg, labs, lmask)

        deterministic = cfg.dropout == 0.0
        for step in range(num_steps):
            idx = rng_np.integers(0, len(X_train),
                                  size=num_accumulation_steps)
            model.train()
            for j in range(0, len(idx), micro_batch):
                sub = idx[j:j + micro_batch]
                w = torch.full((len(sub),), 1.0 / num_accumulation_steps, device=dev)
                contact_loss(model, head, *stage(sub), w,
                             deterministic=deterministic,
                             rng=slot_seed(seed + 41000 + fold, step, j)).backward()
            step_optimizer(opt, sched)

        # test: per-sample predict, token->char upsample, pooled ROC AUC
        model.eval()
        all_preds, all_truths = [], []
        for i in range(0, len(X_test), micro_batch):
            chunk = X_test[i:i + micro_batch]
            x, seg = pad_batch(chunk, 128, MAX_LEN)
            with torch.inference_mode():
                emb = model(*to_device(model, x, seg), return_embeddings=True)
                probs = torch.sigmoid(
                    apply_linear_head(head, emb).float()[..., 0]).cpu().numpy()
            for j, tok in enumerate(chunk):
                plen = L_test[i + j]
                tok_probs = probs[j, 1:plen + 1]
                chars = unprocess_sequence(sp, tok[1:plen + 1], tok_probs)
                all_preds += chars
                all_truths += np.asarray(Y_test[i + j]).tolist()
        del model, opt, sched

        fpr, tpr, _ = roc_curve(all_truths, all_preds)
        roc_auc = float(auc(fpr, tpr))
        print(f"Fold {fold + 1} ROC AUC: {roc_auc}")
        results.append(roc_auc)
        with open(f"pdb_contact_eval_{name_suffix}.jsonl", "a") as f:
            f.write(json.dumps({"fold": fold,
                                "preds": list(map(float, all_preds)),
                                "truths": list(map(float, all_truths)),
                                "roc_auc": roc_auc}) + "\n")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="PDB contact eval")
    ap.add_argument("model_fn")
    ap.add_argument("name_suffix")
    ap.add_argument("--tokenizer_fn", required=True,
                    help="the tokenizer's .model file (the reference's "
                         "tokenizers/mixed_bpe.model)")
    ap.add_argument("--distances_json",
                    default="../datasets/peptide-nucleotide-distances.json")
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--num_epochs", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    a = ap.parse_args(argv)
    return run_pdb_contact(a.model_fn, a.name_suffix, a.tokenizer_fn,
                           distances_json=a.distances_json, folds=a.folds,
                           num_epochs=a.num_epochs, seed=a.seed,
                           device=a.device)


if __name__ == "__main__":
    main()
