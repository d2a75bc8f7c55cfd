"""ProNAB protein–nucleotide binding-affinity evals, PyTorch port of
`omnibiote_tpu/evals/pronab.py`.

The reference's evals/pronab_crossval.py and train_pronab_all.py protocol:
  * dataset: pronab_no_mutations.json records -> (tagged nucleotide seq,
    peptide seq, log10 Kd with noise floor, deltaG) (:35-58)
  * cross-modal input: <protein>+peptide+<EOS> tokens ++ tagged nucleotide
    tokens, truncated to 1024 (:60-79,170)
  * decontamination of the training set against mutation-test peptides
    (:107-131)
  * phase 1: G0 regression pretrain with a ZERO-initialised linear head on
    the first-token embedding, z-normalised targets, OneCycleLR with three
    LR groups — the backbone trains here
  * zero-shot ddG eval of the pretrained model (:227-289)
  * 10-fold grouped cross-val with the dual loss (ddG MSE + absolute dG MSE
    for wild and mutant, in unnormalised G0 space) (:302-365)
  * metrics: PCC and MAE for ddG and dG, appended to
    pronab-mutant-dual_{suffix}.jsonl

Faithfulness note: the reference's cross-val "train" split contains every
group INCLUDING the held-out test group (pronab_crossval.py:306-309 adds all
groups to train_set unconditionally). Default reproduces this; pass
exclude_test_from_train=True for a leakage-free split.

The reference runs 256 accumulation micro-steps of batch 1; gradients are
linear, so the same 256 samples go through in padded mini-batches
(identical gradients up to padding-masked positions). Training forwards run
with the model's dropout (the reference fine-tunes in model.train() mode,
pronab_crossval.py:234,313), each micro-batch on its own integer seed;
prediction is deterministic.
"""
from __future__ import annotations

import argparse
import json
import random
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from scipy.stats import pearsonr

from ..config import OmniBioTAConfig
from ..tokenizer import SentencePieceProcessor
from ..training.checkpoint import load_model_checkpoint, save_pytree_flat
from ..training.train import slot_seed
from ..utils.convert import flatten_tree, jax_head_from_port, jax_params_from_state
from .common import (
    apply_linear_head, make_finetune_optimizer, pad_batch, restore, snapshot,
    step_optimizer, to_device, trainable)

MAX_LEN = 1024


# --------------------------------------------------------------------------
# Data preparation
# --------------------------------------------------------------------------

def process_dataset(dataset: dict, noise_floor: float = 1e-15,
                    rng: Optional[np.random.Generator] = None):
    """(nucleotide tagged seqs, peptides, log10 Kd, G0) (:35-58)."""
    rng = rng or np.random.default_rng(0)
    nuc, pep, Kd, G0 = [], [], [], []
    for key in dataset:
        for item in dataset[key]["binding data"]:
            if item[2] == 0 or item[3] == 0:
                continue
            tag = "<RNA>" if item[1] == "RNA" else "<DNA>"
            nuc.append(tag + item[0] + "<EOS>")
            pep.append(dataset[key]["Sequence"])
            Kd.append(np.log10(item[2] + noise_floor * rng.uniform()
                               + noise_floor))
            G0.append(item[3])
    return nuc, pep, Kd, G0


def prepare_sample(sp, peptide: str, nucleotide: str,
                   banned_tokens: Sequence[int]) -> List[int]:
    """<protein>+peptide+<EOS> tokens ++ tagged nucleotide tokens (:60-79)."""
    banned = set(banned_tokens)
    nuc_ids = [t for t in sp.encode(nucleotide) if t not in banned]
    pep_ids = [t for t in sp.encode("<protein>" + peptide + "<EOS>")
               if t not in banned]
    return pep_ids + nuc_ids


def decontaminate(nuc, pep, Kd, G0, mutation_peptides: set):
    """Drop training entries whose peptide appears in the mutation test set
    (:107-131)."""
    out = [[], [], [], []]
    deleted = 0
    for n, p, k, g in zip(nuc, pep, Kd, G0):
        if p in mutation_peptides:
            deleted += 1
            continue
        out[0].append(n)
        out[1].append(p)
        out[2].append(k)
        out[3].append(g)
    print(f"Deleted {deleted} entries from training set out of {len(nuc)}")
    return (*out,)


def group_by_peptide(mutation_records: List[dict]) -> Dict[str, List[dict]]:
    groups: Dict[str, List[dict]] = {}
    for rec in mutation_records:
        groups.setdefault(rec["peptide_sequence"], []).append(rec)
    return groups


# --------------------------------------------------------------------------
# Steps
# --------------------------------------------------------------------------

def _make_steps(cfg: OmniBioTAConfig, model, head):
    """(regression step, pair step, predict fn) over `model` and `head`.
    The steps add their loss's gradients into the parameters' .grad and
    return the loss; rng is the micro-batch's integer seed (None: no
    dropout)."""

    def g0_pred(tokens, segments, rng=None):
        det = rng is None or cfg.dropout == 0.0
        emb = model(tokens, segments, deterministic=det, rng=rng,
                    return_embeddings=True)
        return apply_linear_head(head, emb[:, 0])[:, 0]

    def reg_step(tokens, segments, targets, weights, rng):
        out = g0_pred(tokens, segments, rng).float()
        loss = (((out - targets) ** 2) * weights).sum()
        loss.backward()
        return loss.detach()

    def pair_step(tw, sw, tm, sm, wild_g0, mut_g0, weights, g0_mean, g0_std,
                  rng):
        # the wild and the mutant forward draw distinct dropout seeds, as
        # the JAX step splits r1, r2 from its key
        r1, r2 = (int(w) for w in np.random.SeedSequence(int(rng))
                  .generate_state(2, np.uint64))
        gw = g0_pred(tw, sw, r1).float() * g0_std + g0_mean
        gm = g0_pred(tm, sm, r2).float() * g0_std + g0_mean
        diff = gm - gw
        gt_diff = mut_g0 - wild_g0
        per = (diff - gt_diff) ** 2 + (gw - wild_g0) ** 2 + (gm - mut_g0) ** 2
        loss = (per * weights).sum()
        loss.backward()
        return loss.detach()

    def predict(tokens, segments):
        model.eval()
        with torch.inference_mode():
            return g0_pred(tokens, segments, None).float()

    return reg_step, pair_step, predict


def _batch(model, samples: List[List[int]]):
    x, seg = pad_batch([s[:MAX_LEN] for s in samples], bucket=128,
                       max_len=MAX_LEN)
    return to_device(model, x, seg)


def predict_g0(predict, model, samples, g0_mean, g0_std, chunk=16):
    preds = []
    for i in range(0, len(samples), chunk):
        out = predict(*_batch(model, samples[i:i + chunk])).cpu().numpy()
        preds += (out * g0_std + g0_mean).tolist()
    return preds


# --------------------------------------------------------------------------
# Main protocol
# --------------------------------------------------------------------------

def evaluate_pairs(predict, model, sp, banned, test_set, g0_mean, g0_std):
    wild = [prepare_sample(sp, r["peptide_sequence"],
                           r["wild_nucleotide_sequence"], banned)
            for r in test_set]
    mut = [prepare_sample(sp, r["peptide_sequence"],
                          r["mutated_nucleotide_sequence"], banned)
           for r in test_set]
    gw = predict_g0(predict, model, wild, g0_mean, g0_std)
    gm = predict_g0(predict, model, mut, g0_mean, g0_std)
    ddg_pred = [m - w for w, m in zip(gw, gm)]
    ddg_true = [r["mutant_G0"] - r["wild_G0"] for r in test_set]
    dg_pred = [v for pair in zip(gw, gm) for v in pair]
    dg_true = [v for r in test_set for v in (r["wild_G0"], r["mutant_G0"])]
    return {
        "ground_truths": ddg_true, "predictions": ddg_pred,
        "dG_ground_truths": dg_true, "dG_predictions": dg_pred,
        "pcc": float(pearsonr(ddg_true, ddg_pred)[0]),
        "MAE": float(np.abs(np.asarray(ddg_true) - np.asarray(ddg_pred)).mean()),
        "dG_pcc": float(pearsonr(dg_true, dg_pred)[0]),
        "dG_MAE": float(np.abs(np.asarray(dg_true) - np.asarray(dg_pred)).mean()),
    }


def run_pronab(
    tokenizer_fn: str,
    model_fn: str,
    output_suffix: str,
    pronab_json: str = "../datasets/pronab_no_mutations.json",
    mutation_jsonl: str = "../datasets/mutation_data.jsonl",
    banned_tokens: Sequence[int] = (65533,),
    num_epochs_pretrain: int = 32,
    num_epochs_cv: int = 256,
    num_accumulation_steps: int = 256,
    micro_batch: int = 16,
    lr: float = 1e-4,
    embed_lr: float = 1e-3,
    head_lr: float = 1e-2,
    folds: int = 10,
    crossval: bool = True,
    exclude_test_from_train: bool = False,
    seed: int = 0,
    eval_every: int = 100,
    save_pretrained: bool = True,
    device=None,
):
    """G0 regression pretrain, zero-shot ddG eval, then the grouped
    cross-val; appends to pronab-mutant-dual_{output_suffix}.jsonl and saves
    the pretrained model and head as pronab_all_ft_{output_suffix}.npz (the
    JAX package's tree layout) in the working directory. device: None (the
    GPU) or e.g. "cpu"."""
    random.seed(seed)
    np.random.seed(seed)
    rng_np = np.random.default_rng(seed)

    sp = SentencePieceProcessor(tokenizer_fn)
    banned = list(banned_tokens)
    model, cfg = load_model_checkpoint(model_fn, device=device)
    dev = next(model.parameters()).device

    with open(pronab_json) as f:
        train_raw = json.load(f)
    nuc, pep, Kd, G0 = process_dataset(train_raw, rng=rng_np)

    mutation_records = []
    with open(mutation_jsonl) as f:
        for line in f:
            mutation_records.append(json.loads(line))
    groups = group_by_peptide(mutation_records)

    nuc, pep, Kd, G0 = decontaminate(nuc, pep, Kd, G0, set(groups))

    g0_mean, g0_std = float(np.mean(G0)), float(np.std(G0))
    targets = (np.asarray(G0) - g0_mean) / g0_std

    samples = [prepare_sample(sp, p, n, banned) for p, n in zip(pep, nuc)]

    # zero-init head (:140-142)
    head = {"w": torch.zeros(cfg.n_embd, 1, device=dev, requires_grad=True),
            "b": torch.zeros(1, device=dev, requires_grad=True)}

    num_steps = max(1, int(num_epochs_pretrain * len(samples)
                           / num_accumulation_steps))
    opt, sched = make_finetune_optimizer(
        model, head, lr=lr, embed_lr=embed_lr, head_lr=head_lr,
        total_steps=num_steps, schedule="onecycle")
    reg_step, pair_step, predict = _make_steps(cfg, model, head)

    # dropout seeds: (seed + 31337 + phase, step, micro-batch), phase 0 the
    # pretraining and 1 + split each fold
    drop_base = seed + 31337
    print(f"Starting pre-training ({num_steps} steps)")
    for step in range(num_steps):
        idx = rng_np.integers(0, len(samples), size=num_accumulation_steps)
        model.train()
        for j in range(0, len(idx), micro_batch):
            sub = idx[j:j + micro_batch]
            x, seg = _batch(model, [samples[i] for i in sub])
            t = torch.as_tensor(targets[sub], dtype=torch.float32, device=dev)
            w = torch.full((len(sub),), 1.0 / num_accumulation_steps, device=dev)
            reg_step(x, seg, t, w, slot_seed(drop_base, step, j))
        step_optimizer(opt, sched)

    if save_pretrained:
        state = {n: p.detach().cpu() for n, p in model.named_parameters()}
        save_pytree_flat(f"pronab_all_ft_{output_suffix}.npz", flatten_tree(
            {"model": jax_params_from_state(state, cfg),
             "head": jax_head_from_port(head)}))

    out_path = f"pronab-mutant-dual_{output_suffix}.jsonl"

    # zero-shot ddG eval of the pretrained model (:227-289)
    test_all = [r for key in groups for r in groups[key]]
    zres = evaluate_pairs(predict, model, sp, banned, test_all,
                          g0_mean, g0_std)
    with open(out_path, "a") as f:
        f.write(json.dumps(zres) + "\n")
    print(f"zero-shot: pcc {zres['pcc']:.4f} MAE {zres['MAE']:.4f} "
          f"dG_pcc {zres['dG_pcc']:.4f}")

    if not crossval:
        return {"zero_shot": zres}

    pretrained = snapshot(trainable(model, head))
    results = {"zero_shot": zres, "folds": []}

    for split in range(folds):
        train_set, test_set = [], []
        for i, key in enumerate(groups):
            if i % folds == split:
                test_set += groups[key]
                if exclude_test_from_train:
                    continue
            train_set += groups[key]

        live = trainable(model, head)
        restore(live, pretrained)
        num_steps = max(1, int(num_epochs_cv * len(train_set)
                               / num_accumulation_steps))
        opt, sched = make_finetune_optimizer(
            model, head, lr=lr, embed_lr=embed_lr, head_lr=head_lr,
            total_steps=num_steps, schedule="onecycle")

        for step in range(num_steps):
            idx = rng_np.integers(0, len(train_set),
                                  size=num_accumulation_steps)
            model.train()
            for j in range(0, len(idx), micro_batch):
                sub = [train_set[i] for i in idx[j:j + micro_batch]]
                xw, sw = _batch(model, [prepare_sample(
                    sp, r["peptide_sequence"], r["wild_nucleotide_sequence"],
                    banned) for r in sub])
                xm, sm = _batch(model, [prepare_sample(
                    sp, r["peptide_sequence"],
                    r["mutated_nucleotide_sequence"], banned) for r in sub])
                wg = torch.tensor([r["wild_G0"] for r in sub], dtype=torch.float32,
                                  device=dev)
                mg = torch.tensor([r["mutant_G0"] for r in sub], dtype=torch.float32,
                                  device=dev)
                w = torch.full((len(sub),), 1.0 / num_accumulation_steps, device=dev)
                pair_step(xw, sw, xm, sm, wg, mg, w, g0_mean, g0_std,
                          slot_seed(drop_base + 1 + split, step, j))
            step_optimizer(opt, sched)

        res = evaluate_pairs(predict, model, sp, banned, test_set,
                             g0_mean, g0_std)
        results["folds"].append(res)
        with open(out_path, "a") as f:
            f.write(json.dumps(res) + "\n")
        print(f"fold {split}: pcc {res['pcc']:.4f} MAE {res['MAE']:.4f} "
              f"dG_pcc {res['dG_pcc']:.4f} dG_MAE {res['dG_MAE']:.4f}")

    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="ProNAB binding affinity eval")
    ap.add_argument("tokenizer_fn")
    ap.add_argument("model_fn")
    ap.add_argument("output_suffix")
    ap.add_argument("--pronab_json",
                    default="../datasets/pronab_no_mutations.json")
    ap.add_argument("--mutation_jsonl",
                    default="../datasets/mutation_data.jsonl")
    ap.add_argument("--no_crossval", action="store_true",
                    help="train_pronab_all.py mode: pretrain + save only")
    ap.add_argument("--exclude_test_from_train", action="store_true")
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    a = ap.parse_args(argv)
    return run_pronab(
        a.tokenizer_fn, a.model_fn, a.output_suffix,
        pronab_json=a.pronab_json, mutation_jsonl=a.mutation_jsonl,
        crossval=not a.no_crossval,
        exclude_test_from_train=a.exclude_test_from_train,
        folds=a.folds, seed=a.seed, device=a.device)


if __name__ == "__main__":
    main()
