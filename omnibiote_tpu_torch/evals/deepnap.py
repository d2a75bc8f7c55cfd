"""DeePNAP baseline, the non-transformer CNN control for the ProNAB ddG task:
PyTorch port of `omnibiote_tpu/evals/deepnap.py`.

The reference's evals/DeePNAP_baseline.ipynb: 9-bit protein / 5-bit
nucleotide encodings (cell 0), parallel conv towers with top/bottom padding
variants, four interaction MLPs, a residual FC trunk with dropout (cell 1);
the same ProNAB pretraining and grouped cross-validation as evals/pronab.py.

As in the JAX package, the pretraining loss compares z-normalised
predictions with z-normalised targets (the notebook's cell 7 compares
un-normalised predictions with normalised targets); that changes the
baseline's own training only, not the shared evaluation protocol.
Dropout 0.5 after fc1 and fc2 in pretraining draws from the port's own
seeds.

Usage:
  python -m omnibiote_tpu_torch.evals.deepnap --pronab_json P --mutation_jsonl M \
      [--device cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F
from scipy.stats import pearsonr
from torch import nn

from ..training.train import slot_seed
from ..utils.device import resolve_device
from .common import adamw, linear_to_zero, restore, snapshot, step_optimizer
from .pronab import decontaminate, group_by_peptide, process_dataset

PROTEIN_MAPPING = {
    "D": [0, 0, 0, 1, 1, 1, 1, 0, 0], "E": [0, 0, 1, 0, 1, 1, 1, 0, 0],
    "K": [0, 0, 1, 1, 0, 1, 1, 0, 0], "R": [0, 0, 1, 1, 1, 0, 1, 0, 0],
    "H": [0, 1, 0, 0, 1, 1, 1, 0, 0], "S": [0, 1, 0, 1, 0, 1, 0, 1, 0],
    "T": [0, 1, 0, 1, 1, 0, 0, 1, 0], "N": [0, 1, 1, 0, 0, 1, 0, 1, 0],
    "Q": [0, 1, 1, 0, 1, 0, 0, 1, 0], "Y": [0, 1, 1, 1, 0, 0, 0, 1, 0],
    "G": [1, 0, 0, 0, 1, 1, 0, 0, 1], "A": [1, 0, 0, 1, 0, 1, 0, 0, 1],
    "V": [1, 0, 0, 1, 1, 0, 0, 0, 1], "L": [1, 0, 1, 0, 0, 1, 0, 0, 1],
    "I": [1, 0, 1, 0, 1, 0, 0, 0, 1], "M": [1, 0, 1, 1, 0, 0, 0, 0, 1],
    "F": [1, 1, 0, 0, 0, 1, 0, 0, 1], "W": [1, 1, 0, 0, 1, 0, 0, 0, 1],
    "P": [1, 1, 0, 1, 0, 0, 0, 0, 1], "C": [1, 1, 1, 0, 0, 0, 0, 0, 1],
}
NUCLEOTIDE_MAPPING = {
    "A": [1, 0, 0, 0, 0], "C": [0, 1, 0, 0, 0], "G": [0, 0, 1, 0, 0],
    "T": [0, 0, 0, 1, 0], "U": [0, 0, 0, 0, 1],
}

P_LEN, P_DIM = 1000, 9
N_LEN, N_DIM = 75, 5
PRETRAIN_DROPOUT = 0.5


def encode_peptide(peptide: str) -> np.ndarray:
    rows = [PROTEIN_MAPPING.get(a, [0] * P_DIM) for a in peptide.upper()]
    arr = np.asarray(rows, np.float32)
    if arr.shape[0] < P_LEN:
        arr = np.concatenate([arr, np.zeros((P_LEN - arr.shape[0], P_DIM),
                                            np.float32)])
    return arr[:P_LEN]


def encode_nucleotide(seq: str) -> np.ndarray:
    rows = [NUCLEOTIDE_MAPPING.get(c, [0] * N_DIM) for c in seq.upper()
            if c in NUCLEOTIDE_MAPPING or c.isalpha()]
    arr = (np.asarray(rows, np.float32) if rows
           else np.zeros((0, N_DIM), np.float32))
    if arr.shape[0] < N_LEN:
        arr = np.concatenate([arr, np.zeros((N_LEN - arr.shape[0], N_DIM),
                                            np.float32)])
    return arr[:N_LEN]


def _strip(s: str) -> str:
    return s.replace("<DNA>", "").replace("<RNA>", "").replace("<EOS>", "")


# --------------------------------------------------------------------------
# Model
# --------------------------------------------------------------------------

def _tower(conv: nn.Conv2d, x, pad):
    """x (B, 1, L, D): pad rows (top, bottom), VALID conv with the conv's
    stride, ReLU, max over channels, flatten -> (B, L')."""
    h = F.relu(conv(F.pad(x, (0, 0, pad[0], pad[1]))))  # (B, C, L', 1)
    return h.amax(dim=1).reshape(h.shape[0], -1)


def _interaction(fan_in: int, device):
    return nn.ModuleList([nn.Linear(fan_in, 96, device=device),
                          nn.Linear(96, 32, device=device)])


class DeePNAP(nn.Module):
    """protein (B, 1, 1000, 9) and nucleotide (B, 1, 75, 5) -> (B, 1)."""

    def __init__(self, *, device=None):
        super().__init__()
        self.protein_conv1 = nn.Conv2d(1, 48, (6, P_DIM), stride=(6, 1), device=device)
        self.protein_conv2 = nn.Conv2d(1, 48, (6, P_DIM), stride=(6, 1), device=device)
        self.dna_conv1 = nn.Conv2d(1, 32, (2, N_DIM), stride=(2, 1), device=device)
        self.dna_conv2 = nn.Conv2d(1, 32, (2, N_DIM), stride=(2, 1), device=device)
        width = (P_LEN + 8) // 6 + (N_LEN + 3) // 2   # 168 + 39 tower outputs
        self.int_p1_n1 = _interaction(width, device)
        self.int_p1_n2 = _interaction(width, device)
        self.int_p2_n1 = _interaction(width, device)
        self.int_p2_n2 = _interaction(width, device)
        self.fc1 = nn.Linear(128, 256, device=device)
        self.fc2 = nn.Linear(256, 128, device=device)
        self.fc3 = nn.Linear(128, 64, device=device)
        self.fc4 = nn.Linear(64, 1, device=device)

    def forward(self, protein, nucleotide, dropout_rate: float = 0.0, seed=None):
        """dropout_rate > 0 with an integer `seed` drops after fc1 and fc2
        (inverted dropout); otherwise deterministic."""
        lrelu = lambda v: F.leaky_relu(v, 0.01)
        p1 = _tower(self.protein_conv1, protein, (0, 8))
        p2 = _tower(self.protein_conv2, protein, (8, 0))
        n1 = _tower(self.dna_conv1, nucleotide, (0, 3))
        n2 = _tower(self.dna_conv2, nucleotide, (3, 0))

        def interact(mlp, a, b):
            return lrelu(mlp[1](lrelu(mlp[0](torch.cat([a, b], -1)))))

        x = torch.cat([interact(self.int_p1_n1, p1, n1), interact(self.int_p1_n2, p1, n2),
                       interact(self.int_p2_n1, p2, n1), interact(self.int_p2_n2, p2, n2)], -1)
        gen = (torch.Generator(device=x.device).manual_seed(int(seed))
               if dropout_rate > 0 and seed is not None else None)

        def dropout(v):
            if gen is None:
                return v
            keep = torch.rand(v.shape, generator=gen, device=v.device) < 1 - dropout_rate
            return torch.where(keep, v / (1 - dropout_rate), 0.0)

        res = dropout(lrelu(self.fc1(x)))
        res = dropout(lrelu(self.fc2(res)))
        x = x + res
        return self.fc4(lrelu(self.fc3(x)))


@torch.no_grad()
def init_deepnap(generator: torch.Generator, *, device=None) -> DeePNAP:
    """DeePNAP with torch's default init, U(±1/sqrt(fan_in)) for every
    weight and bias, drawn from `generator` (on its device) in the JAX
    package's order: the four convs, the interaction MLPs, fc1-fc4."""
    model = DeePNAP(device=device)
    for module in model.modules():
        if isinstance(module, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / np.sqrt(module.weight[0].numel())
            for p in (module.weight, module.bias):
                p.copy_(torch.empty(p.shape, device=generator.device).uniform_(
                    -bound, bound, generator=generator))
    return model


def apply_deepnap(model: DeePNAP, protein, nucleotide, *, dropout_rate: float = 0.0,
                  seed=None):
    """model(protein, nucleotide): the one call run_deepnap makes of the
    model, pretraining (with dropout) and prediction alike."""
    return model(protein, nucleotide, dropout_rate, seed)


# --------------------------------------------------------------------------
# ProNAB protocol with the CNN
# --------------------------------------------------------------------------

def run_deepnap(
    pronab_json: str,
    mutation_jsonl: str,
    output_suffix: str = "deepnap",
    num_epochs: int = 32,
    batch_size: int = 256,
    lr: float = 1e-3,
    folds: int = 10,
    num_epochs_cv: int = 64,
    seed: int = 0,
    device=None,
):
    """Pretrain on the decontaminated ProNAB G0 records, evaluate ddG
    zero-shot on every mutation pair, then cross-validate over the peptide
    groups with the ddG + dG dual loss; each result is a line of
    deepnap-mutant-dual_{output_suffix}.jsonl in the working directory.
    Returns {"zero_shot": ..., "folds": [...]}. device: None (the GPU) or
    e.g. "cpu"."""
    dev = resolve_device(device)
    rng_np = np.random.default_rng(seed)
    with open(pronab_json) as f:
        ds = json.load(f)
    nuc, pep, Kd, G0 = process_dataset(ds, rng=rng_np)
    mutation_records = []
    with open(mutation_jsonl) as f:
        for line in f:
            mutation_records.append(json.loads(line))
    groups = group_by_peptide(mutation_records)
    nuc, pep, Kd, G0 = decontaminate(nuc, pep, Kd, G0, set(groups))

    g0_mean, g0_std = float(np.mean(G0)), float(np.std(G0))
    X_p = torch.from_numpy(np.stack([encode_peptide(p)[None] for p in pep])).to(dev)
    X_n = torch.from_numpy(np.stack([encode_nucleotide(_strip(n))[None]
                                     for n in nuc])).to(dev)
    y = torch.from_numpy((np.asarray(G0, np.float32) - g0_mean) / g0_std).to(dev)

    model = init_deepnap(torch.Generator().manual_seed(seed), device=dev)
    num_steps = max(1, int(num_epochs * len(pep) / batch_size))
    opt, sched = adamw([list(model.parameters())], [linear_to_zero(lr, num_steps)])

    for step in range(num_steps):
        idx = torch.from_numpy(rng_np.choice(len(pep), min(batch_size, len(pep)),
                                             replace=False)).to(dev)
        out = apply_deepnap(model, X_p[idx], X_n[idx], dropout_rate=PRETRAIN_DROPOUT,
                            seed=slot_seed(seed + 1, step, 0))[:, 0]
        torch.mean((out - y[idx]) ** 2).backward()
        step_optimizer(opt, sched)

    def predict(xp, xn):
        with torch.inference_mode():
            return (apply_deepnap(model, xp, xn)[:, 0] * g0_std + g0_mean).cpu().numpy()

    def encode(records):
        xp = np.stack([encode_peptide(r["peptide_sequence"])[None] for r in records])
        xw = np.stack([encode_nucleotide(_strip(r["wild_nucleotide_sequence"]))[None]
                       for r in records])
        xm = np.stack([encode_nucleotide(_strip(r["mutated_nucleotide_sequence"]))[None]
                       for r in records])
        return (torch.from_numpy(a).to(dev) for a in (xp, xw, xm))

    def eval_pairs(records):
        xp, xw, xm = encode(records)
        gw, gm = predict(xp, xw), predict(xp, xm)
        ddg_p = (gm - gw).tolist()
        ddg_t = [r["mutant_G0"] - r["wild_G0"] for r in records]
        dg_p = [v for pair in zip(gw.tolist(), gm.tolist()) for v in pair]
        dg_t = [v for r in records for v in (r["wild_G0"], r["mutant_G0"])]
        return {
            "pcc": float(pearsonr(ddg_t, ddg_p)[0]),
            "MAE": float(np.abs(np.asarray(ddg_t) - np.asarray(ddg_p)).mean()),
            "dG_pcc": float(pearsonr(dg_t, dg_p)[0]),
            "dG_MAE": float(np.abs(np.asarray(dg_t) - np.asarray(dg_p)).mean()),
        }

    out_path = f"deepnap-mutant-dual_{output_suffix}.jsonl"
    test_all = [r for key in groups for r in groups[key]]
    results = {"zero_shot": eval_pairs(test_all), "folds": []}
    print(f"deepnap zero-shot: {results['zero_shot']}")
    with open(out_path, "a") as f:
        f.write(json.dumps(results["zero_shot"]) + "\n")

    # grouped cross-val on the mutation data with the ddG + dG dual loss
    # (notebook cells 9-12, mirroring the pronab protocol)
    live = dict(model.named_parameters())
    pretrained = snapshot(live)
    for split in range(folds):
        train_set, test_set = [], []
        for i, key in enumerate(groups):
            if i % folds == split:
                test_set += groups[key]
            train_set += groups[key]  # reference contamination reproduced
        if not test_set:
            continue
        restore(live, pretrained)
        cv_steps = max(1, int(num_epochs_cv * len(train_set) / batch_size))
        opt, sched = adamw([list(model.parameters())], [linear_to_zero(lr, cv_steps)])
        for step in range(cv_steps):
            # full batch_size per step: cv_steps is sized from batch_size
            idx = rng_np.integers(0, len(train_set),
                                  size=min(batch_size, len(train_set)))
            sub = [train_set[i] for i in idx]
            xp, xw, xm = encode(sub)
            wg = torch.tensor([r["wild_G0"] for r in sub], dtype=torch.float32, device=dev)
            mg = torch.tensor([r["mutant_G0"] for r in sub], dtype=torch.float32, device=dev)
            gw = apply_deepnap(model, xp, xw)[:, 0] * g0_std + g0_mean
            gm = apply_deepnap(model, xp, xm)[:, 0] * g0_std + g0_mean
            torch.mean((gm - gw - (mg - wg)) ** 2 + (gw - wg) ** 2
                       + (gm - mg) ** 2).backward()
            step_optimizer(opt, sched)

        res = eval_pairs(test_set)
        results["folds"].append(res)
        with open(out_path, "a") as f:
            f.write(json.dumps(res) + "\n")
        print(f"deepnap fold {split}: pcc {res['pcc']:.4f} MAE {res['MAE']:.4f}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description="DeePNAP CNN baseline (ProNAB)")
    ap.add_argument("--pronab_json",
                    default="../datasets/pronab_no_mutations.json")
    ap.add_argument("--mutation_jsonl",
                    default="../datasets/mutation_data.jsonl")
    ap.add_argument("--output_suffix", default="deepnap")
    ap.add_argument("--num_epochs", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    a = ap.parse_args(argv)
    return run_deepnap(a.pronab_json, a.mutation_jsonl, a.output_suffix,
                       num_epochs=a.num_epochs, seed=a.seed, device=a.device)


if __name__ == "__main__":
    main()
