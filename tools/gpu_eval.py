#!/usr/bin/env python3
"""Fine-tuning eval runs of all seven benchmark families on the GPU, with the
PyTorch port (`omnibiote_tpu_torch.evals`), -> EVAL_GPU.json.

    python3 tools/gpu_eval.py [--out EVAL_GPU.json] [--device cpu]

The port's counterpart of eval_tpu.py, in its order and with its fixture
generators, so that every family's fine-tune stack (tokenize -> bucket ->
attention -> head / CNN gradients -> metric) runs end to end on the card:

  * GUE-style sequence classifier (first-token head, MCC)
  * ProteinGLUE SS3 token-level task (mode-aligned labels, ACC)
  * TAPE fluorescence regression (z-scored, Spearman)
  * TAPE contact (ResNet CNN head on bucketed pair images, valid-masked
    BatchNorm; contacts are exactly the W-W pairs)
  * ProNAB dual loss (G0 fine-tune + grouped CV fold)
  * PDB contact (per-residue sigmoid head, ROC-AUC)
  * DeePNAP baseline (the CNN from scratch on the ProNAB records)

The model is eval_tpu.py's flash-capable checkpoint (2 layers, d 256, 2
heads of 128, bf16 compute, block 1024) with random weights from a seed,
written by the port. The vocabulary is a BPE trained by
`tokenizer.train_bpe` on the fixtures' text, and the ProNAB records are
made from a seed (G0 a function of the nucleotide's GC share, plus noise;
rows marked "real_data": false): eval_tpu.py reads the reference's
tokenizer and ProNAB records, which this tool does not need.

Each family is timed and its launches of the flash forward and backward
kernels counted; a family that raises is recorded and the run goes on.
EVAL_GPU.json is written after every family, with the card's name and
power limit (nvidia-smi) on every row. The script exits non-zero if a
family failed or missed eval_tpu.py's quality floors. It needs a GPU
unless given --device cpu.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# eval_tpu.py's floors on the families whose synthetic tasks are separable
# by construction (chance: MCC 0, ACC 1/3, ROC-AUC 0.5, AUPRC about the
# W-W pair share, 1/64)
QUALITY_FLOORS = {"GUE": ("MCC", 0.3), "ProteinGLUE SS3": ("ACC", 0.36),
                  "PDB contact": ("ROC-AUC", 0.6),
                  "TAPE contact": ("medium+long AUPRC", 0.10)}
FAMILIES = 7
VOCAB_SIZE = 128
SPECIALS = ["<EOS>", "<DNA>", "<protein>", "<RNA>"]


# ---------------------------------------------------------------------------
# Fixtures (eval_tpu.py's generators; ProNAB records from a seed)
# ---------------------------------------------------------------------------

def make_gue_tree(root, n_train=64, n_val=32, n_test=32, seq_len=24, seed=0):
    rng = np.random.default_rng(seed)
    task_dir = os.path.join(root, "tf", "0")
    os.makedirs(task_dir)
    for fname, n in (("train.csv", n_train), ("dev.csv", n_val),
                     ("test.csv", n_test)):
        lines = ["sequence,label"]
        for i in range(n):
            y = i % 2
            prefix = "GGGGCCGGGGCC" if y else "ATATATATATAT"
            seq = prefix + "".join(rng.choice(list("ACGT"), size=seq_len))
            lines.append(f"{seq},{y}")
        with open(os.path.join(task_dir, fname), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def _protein_for_class(rng, y, n=24):
    pool = list("AW") if y else list("LV")
    return "".join(rng.choice(pool, size=n))


def make_pglue_dir(root, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(root)
    # ss_* for SS3 plus the CB513 test-only variant its head evaluates
    for fname, n in (("ss_training.csv", 40), ("ss_validation.csv", 12),
                     ("ss_test.csv", 12), ("ss_cb513_test.csv", 12)):
        lines = ["sequence,ss3"]
        for i in range(n):
            seq = _protein_for_class(rng, i % 2, n=20)
            lab = [(0 if c == "A" else 1 if c == "W" else 2) for c in seq]
            lines.append(seq + ",[" + " ".join(str(v) for v in lab) + "]")
        with open(os.path.join(root, fname), "w") as f:
            f.write("\n".join(lines) + "\n")
    return root


def make_tape_dirs(base, seed=2):
    """fluorescence + proteinnet fixtures (tape.py / contact.py layouts)."""
    rng = np.random.default_rng(seed)
    fl = os.path.join(base, "tape", "fluorescence")
    os.makedirs(fl)
    for split, n in (("train", 48), ("valid", 16), ("test", 16)):
        data = []
        for i in range(n):
            y = i % 2
            pool = list("AW") if y else list("LV")
            data.append({"primary": "".join(rng.choice(pool, size=24)),
                         "log_fluorescence": [float(y) * 2.0 + 0.1]})
        with open(os.path.join(fl, f"fluorescence_{split}.json"), "w") as f:
            json.dump(data, f)
    pn = os.path.join(base, "contact", "proteinnet")
    os.makedirs(pn)
    for split, n_rec in (("train", 10), ("valid", 4), ("test", 4)):
        data = []
        for _ in range(n_rec):
            n = int(rng.integers(30, 50))
            seq = "".join(rng.choice(list("MKVLAGIW"), size=n))
            # separable geometry: W residues cluster in an r=2 ball at the
            # origin (every W-W pair is a < 8 A contact at any sequence
            # separation); everything else sits on a 20 A-spaced line (no
            # contacts) — so the pairwise CNN head must learn
            # contact(i,j) = (seq[i] == seq[j] == 'W') from embeddings
            tert = np.zeros((n, 3))
            for i, ch in enumerate(seq):
                if ch == "W":
                    tert[i] = rng.uniform(-2, 2, size=3)
                else:
                    tert[i] = (20.0 * (i + 2), 0.0, 0.0)
            data.append({"primary": seq, "tertiary": tert.tolist(),
                         "valid_mask": [1] * n})
        with open(os.path.join(pn, f"proteinnet_{split}.json"), "w") as f:
            json.dump(data, f)
    return os.path.join(base, "tape"), os.path.join(base, "contact")


def _g0(rng, nucleotide):
    """A binding free energy that the nucleotide determines up to noise:
    -6 kcal/mol minus 8 times its GC share."""
    gc = sum(c in "GC" for c in nucleotide) / max(len(nucleotide), 1)
    return float(-6.0 - 8.0 * gc + rng.normal(0.0, 0.3))


def make_pronab(path, n_proteins=40, seed=4):
    """ProNAB records in pronab_no_mutations.json's layout: n_proteins
    peptides of 50-400 residues, 4-9 binding rows each (DNA or RNA of 10-40
    nucleotides, a Kd and a G0)."""
    rng = np.random.default_rng(seed)
    ds = {}
    for k in range(n_proteins):
        pep = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=int(rng.integers(50, 400))))
        rows = []
        for _ in range(int(rng.integers(4, 10))):
            nuc = "".join(rng.choice(list("ACGT"), size=int(rng.integers(10, 40))))
            rows.append([nuc, "RNA" if rng.random() < 0.2 else "DNA",
                         float(10 ** -rng.uniform(3, 9)), _g0(rng, nuc), ""])
        ds[f"SYN{k:03d}"] = {"Sequence": pep, "binding data": rows}
    with open(path, "w") as f:
        json.dump(ds, f)
    return path, ds


def make_mutation_jsonl(path, peptides, seed=3):
    """Mutation eval pairs over the given peptides (decontamination then
    drops their ProNAB records, as in the protocol): one nucleotide of 14
    changed, G0 by the same rule as the records."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for pep in peptides:
            for _ in range(3):
                wild = "".join(rng.choice(list("ACGT"), size=14))
                mut = wild[:6] + ("T" if wild[6] != "T" else "A") + wild[7:]
                f.write(json.dumps({
                    "peptide_sequence": pep,
                    "wild_nucleotide_sequence": f"<DNA>{wild}<EOS>",
                    "mutated_nucleotide_sequence": f"<DNA>{mut}<EOS>",
                    "wild_G0": _g0(rng, wild),
                    "mutant_G0": _g0(rng, mut),
                }) + "\n")
    return path


def make_pdb_json(path, seed=5):
    rng = np.random.default_rng(seed)
    data = []
    for _ in range(6):
        pep = "".join(rng.choice(list("MKVLAGIW"), size=14))
        for _ in range(3):
            nuc = "".join(rng.choice(list("ACGT"), size=10))
            # separable: M/K residues contact (<= 8 A), the rest do not
            dists = np.where(np.isin(list(pep), ["M", "K"]),
                             rng.uniform(2, 6, size=14), rng.uniform(12, 20, size=14))
            data.append({"peptide_sequences": {"A": pep},
                         "nucleotide_sequences": {"B": nuc},
                         "closest_nucleotides": dists.tolist()})
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def make_fixtures(root):
    """Every family's dataset under root. Returns their paths and the
    tagged sentences of all their sequences (the vocabulary's corpus)."""
    paths = {"gue": make_gue_tree(os.path.join(root, "GUE")),
             "pglue": make_pglue_dir(os.path.join(root, "ProteinGLUE"))}
    paths["tape"], paths["contact"] = make_tape_dirs(root)
    paths["pronab"], ds = make_pronab(os.path.join(root, "pronab.json"))
    peptides = sorted(v["Sequence"] for v in ds.values())[:6]
    paths["mutations"] = make_mutation_jsonl(os.path.join(root, "mutations.jsonl"), peptides)
    paths["pdb"] = make_pdb_json(os.path.join(root, "distances.json"))

    proteins, nucleotides = [], []
    for name in os.listdir(os.path.join(paths["gue"], "tf", "0")):
        with open(os.path.join(paths["gue"], "tf", "0", name)) as f:
            nucleotides += [line.split(",")[0] for line in f.read().splitlines()[1:]]
    for name in os.listdir(paths["pglue"]):
        with open(os.path.join(paths["pglue"], name)) as f:
            proteins += [line.split(",")[0] for line in f.read().splitlines()[1:]]
    for d, key in ((os.path.join(paths["tape"], "fluorescence"), "primary"),
                   (os.path.join(paths["contact"], "proteinnet"), "primary")):
        for name in os.listdir(d):
            with open(os.path.join(d, name)) as f:
                proteins += [r[key] for r in json.load(f)]
    for v in ds.values():
        proteins.append(v["Sequence"])
        nucleotides += [row[0] for row in v["binding data"]]
    with open(paths["pdb"]) as f:
        for r in json.load(f):
            proteins += list(r["peptide_sequences"].values())
            nucleotides += list(r["nucleotide_sequences"].values())
    corpus = ([f"<protein>{s}<EOS>" for s in proteins]
              + [f"<DNA>{s}<EOS>" for s in nucleotides])
    return paths, corpus


def write_checkpoint(path, device):
    """eval_tpu.py's flash-capable model (head dim 128, block 1024, bf16
    compute) with random weights from a seed, as a port checkpoint."""
    import torch
    from omnibiote_tpu_torch import OmniBioTAConfig, init_params
    from omnibiote_tpu_torch.training.checkpoint import save_model_checkpoint
    cfg = OmniBioTAConfig(n_layer=2, n_head=2, n_embd=256, vocab_size=2 ** 16,
                          block_size=1024, dropout=0.0, compute_dtype="bfloat16")
    model = init_params(torch.Generator(device=device).manual_seed(0), cfg, device=device)
    return save_model_checkpoint(model, path)


def check_floors(results):
    """The failures of eval_tpu.py's quality floors among result rows."""
    failures = []
    for r in results:
        for prefix, (metric, floor) in QUALITY_FLOORS.items():
            if r["task"].startswith(prefix) and not r["value"] >= floor:
                failures.append(f"{r['task']}: {metric} {r['value']} < floor {floor}")
    return failures


def gpu_name_and_power():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# The run
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "EVAL_GPU.json"))
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    out_path = os.path.abspath(args.out)   # the run works in a temporary directory
    sys.path.insert(0, ROOT)
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor, train_bpe
    from omnibiote_tpu_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    gpu = None
    if cuda:
        gpu = gpu_name_and_power()
        print(gpu, flush=True)
        t0 = time.time()
        _kernels.build_all()
        print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    device = None if cuda else str(dev)
    tmp = tempfile.mkdtemp()
    paths, corpus = make_fixtures(tmp)
    sp_path = os.path.join(tmp, "fixtures_bpe.model")
    train_bpe(corpus, vocab_size=VOCAB_SIZE, out_path=sp_path, user_defined=SPECIALS)
    sp = SentencePieceProcessor(sp_path)
    ban = sp.piece_to_id("▁")   # the role of 65533 in the reference vocabulary
    ckpt = write_checkpoint(os.path.join(tmp, "ckpt"), dev)
    results, failures = [], []
    cwd = os.getcwd()
    os.chdir(tmp)

    def gue():
        from omnibiote_tpu_torch.evals.gue import run_gue
        r = run_gue(sp_path, ckpt, ban, gue_dir=paths["gue"], pretraining_epochs=1,
                    pretraining_num_accum_steps=2, batch_size=8, pretraining_lr=1e-3,
                    finetuning_lr=1e-3, output_suffix="gpu", seed=0, device=device)
        task, res = next(iter(r.items()))
        return {"task": f"GUE {os.path.relpath(task, tmp)} (synthetic motif)",
                "metric": "MCC", "value": float(res["mcc"])}

    def pglue():
        from omnibiote_tpu_torch.evals.proteinglue import run_proteinglue
        r = run_proteinglue(sp_path, ckpt, banned_token=ban, eval_dir=paths["pglue"],
                            output_suffix="gpu", tasks=["SS3"], num_epochs=4,
                            batch_size=8, seed=0, force_clean=True, device=device)
        return {"task": "ProteinGLUE SS3 (synthetic, token-level)", "metric": "ACC",
                "value": float(r["SS3"])}

    def tape():
        from omnibiote_tpu_torch.evals.tape import run_tape
        r = run_tape(sp_path, ckpt, banned_token=ban, tape_dir=paths["tape"],
                     output_suffix="gpu", tasks=["fluorescence"], num_epochs=4,
                     batch_size=8, seed=0, device=device)
        return {"task": "TAPE fluorescence (synthetic, regression)", "metric": "SCC",
                "value": float(r["fluorescence"])}

    def contact():
        from omnibiote_tpu_torch.evals.contact import run_contact_eval
        r = run_contact_eval(sp_path, ckpt, banned_token=ban, data_dir=paths["contact"],
                             num_epochs=8, num_accumulation_steps=4, num_tests=2,
                             resnet_blocks=2, seed=0, cache=False, device=device)
        _, _, ma, la = r["test_best"]
        _, _, fma, fla = r["test"]
        return {"task": "TAPE contact (synthetic, ResNet CNN head)",
                "metric": "medium+long AUPRC", "value": float((ma + la) / 2),
                "final_model_auprc": float((fma + fla) / 2)}

    def pronab():
        from omnibiote_tpu_torch.evals.pronab import run_pronab
        r = run_pronab(sp_path, ckpt, "gpu", pronab_json=paths["pronab"],
                       mutation_jsonl=paths["mutations"], banned_tokens=[ban],
                       num_epochs_pretrain=2, num_epochs_cv=8, num_accumulation_steps=32,
                       micro_batch=8, folds=2, seed=0, device=device)
        return {"task": "ProNAB dual-loss (synthetic records, fold 0)", "metric": "dG_MAE",
                "value": float(r["folds"][0]["dG_MAE"]), "real_data": False,
                "zero_shot_MAE": float(r["zero_shot"]["MAE"])}

    def pdb():
        from omnibiote_tpu_torch.evals.pdb_contact import run_pdb_contact
        aucs = run_pdb_contact(ckpt, "gpu", sp_path, distances_json=paths["pdb"],
                               banned_tokens=[ban], num_epochs=4, num_accumulation_steps=8,
                               micro_batch=4, folds=2, seed=0, device=device)
        return {"task": "PDB contact (synthetic, per-residue head)", "metric": "ROC-AUC",
                "value": float(np.mean(aucs))}

    def deepnap():
        from omnibiote_tpu_torch.evals.deepnap import run_deepnap
        r = run_deepnap(paths["pronab"], paths["mutations"], output_suffix="gpu",
                        num_epochs=4, batch_size=64, folds=2, num_epochs_cv=4, seed=0,
                        device=device)
        return {"task": "DeePNAP baseline (synthetic records)",
                "metric": "zero-shot ddG MAE", "value": float(r["zero_shot"]["MAE"]),
                "real_data": False}

    def flush():
        out = {"device": torch.cuda.get_device_name(0) if cuda else str(dev),
               "gpu": gpu, "torch": torch.__version__,
               "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
               "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
               "vocab_size": VOCAB_SIZE, "results": results, "failures": failures}
        with open(out_path, "w") as f:
            json.dump(out, f, indent=2)
        return out

    try:
        for fn in (gue, pglue, tape, contact, pronab, pdb, deepnap):
            _kernels.reset_launches()
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            try:
                row = fn()
            except Exception as e:  # record and go on: one family's failure
                failures.append(f"{fn.__name__}: {type(e).__name__}: {e}")
                traceback.print_exc()
                print(f"FAIL {fn.__name__}: {e}", flush=True)
            else:
                if cuda:
                    torch.cuda.synchronize()
                row.update({
                    "wall_s": time.time() - t0,
                    "launches": {k: _kernels.LAUNCHES[k] for k in ("mh_flash_fwd",
                                                                  "mh_flash_bwd")},
                    "peak_allocated_gib": (torch.cuda.max_memory_allocated() / 2**30
                                           if cuda else None),
                    "gpu": gpu})
                results.append(row)
                print(json.dumps(row), flush=True)
            flush()
    finally:
        os.chdir(cwd)
    failures.extend(check_floors(results))
    if len(results) != FAMILIES:
        failures.append(f"{len(results)} of {FAMILIES} families ran")
    print(json.dumps(flush()))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
