"""PyTorch port vs the JAX package: the eval families end to end
(`run_gue`, `run_tape`, `run_proteinglue`, `run_pronab`,
`run_pdb_contact`) on tiny synthetic fixtures, through both packages with
the same checkpoint (written by the JAX Trainer: fp32, dense attention,
dropout 0) and the same `train_bpe` vocabulary; the port's heads are the
JAX heads (injected). Held: the returned numbers (metrics 1e-6; ProNAB's
and PDB's predictions rtol 2e-4 / atol 2e-5 in G0 and probability units,
and their metrics within what that moves them), the output files (the GUE
CSV with header `Task,MCC,F1`, the TAPE and ProteinGLUE CSVs, the ProNAB
and PDB jsonl lines, the ProNAB npz tree), the ProteinGLUE cleaning
without pandas, and the CLIs' flags: the JAX ones plus --device.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import argparse
import json
import os

import numpy as np
import pytest
from scipy.stats import pearsonr

from omnibiote_tpu.evals import gue as jgue, pdb_contact as jpdb, pronab as jpronab
from omnibiote_tpu.evals import proteinglue as jpglue, tape as jtape
from omnibiote_tpu_torch.evals import engine, gue, pdb_contact, pronab, proteinglue
from omnibiote_tpu_torch.evals import tape, token_finetune
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor
from omnibiote_tpu_torch.training.checkpoint import load_pytree_flat

from test_torch_eval_common import (
    ATOL, METRIC_ATOL, RTOL, banned, jax_head_injector, make_checkpoint, make_tokenizer)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("families")
    tok = make_tokenizer(root)
    return make_checkpoint(root), tok, banned(SentencePieceProcessor(tok))[0]


def _in(path, monkeypatch):
    os.makedirs(path, exist_ok=True)
    monkeypatch.chdir(path)
    return path


def _protein(rng, y, n=20):
    main = "W" if y else "A"
    return "".join(rng.choice([main] * 3 + list("MKVLGI"), size=n))


# Pearson's r of regression outputs: fp32 predictions that differ by ~1e-6
# relative (sums in another order) move r by as much (2.1e-6 measured on
# ProteinGLUE ASA here); every metric of discrete predictions is held to 1e-6
PCC_ATOL = 1e-5


def _close_tree(got, want, what="", atol=None):
    """Nested dicts / lists of numbers: equal structure, metrics to 1e-6
    (or atol: {key: tolerance})."""
    atol = atol or {}
    if isinstance(want, dict):
        assert set(got) == set(want), (what, set(got) ^ set(want))
        for k in want:
            _close_tree(got[k], want[k], f"{what}/{k}", atol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _close_tree(g, w, f"{what}[{i}]", atol)
    else:
        tol = atol.get(what.rsplit("/", 1)[-1], METRIC_ATOL)
        assert abs(float(got) - float(want)) <= tol, (what, got, want)


def test_gue_cli_matches_jax(setup, tmp_path, monkeypatch):
    ckpt, tok, ban = setup
    rng = np.random.default_rng(0)
    task_dir = tmp_path / "GUE" / "tf" / "0"
    os.makedirs(task_dir)
    for fname, n in (("train.csv", 4), ("dev.csv", 4), ("test.csv", 4)):
        lines = ["sequence,label"]
        for i in range(n):
            prefix = "GGGGCCGGGGCC" if i % 2 else "ATATATATATAT"
            lines.append(prefix + "".join(rng.choice(list("ACGT"), size=24)) + f",{i % 2}")
        (task_dir / fname).write_text("\n".join(lines) + "\n")
    # one domain-MLM step, then 32 epochs ('tf') of 4 sequences: 8 steps
    kw = dict(pretraining_epochs=4, pretraining_num_accum_steps=4, batch_size=4,
              pretraining_lr=1e-3, finetuning_lr=1e-3, output_suffix="t", seed=0)
    _in(tmp_path / "jax", monkeypatch)
    want = jgue.run_gue(tok, ckpt, ban, gue_dir=str(tmp_path / "GUE"), **kw)
    _in(tmp_path / "port", monkeypatch)
    jax_head_injector(monkeypatch, engine, split=True)
    argv = ["--sp_dir", tok, "--model_dir", ckpt, "--banned_token", str(ban),
            "--gue_dir", str(tmp_path / "GUE"), "--device", "cpu"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    got = gue.main(argv)
    _close_tree(got, want)
    rows = {}
    for side in ("jax", "port"):
        text = (tmp_path / side / "GUE_results_t.csv").read_text().splitlines()
        assert text[0] == "Task,MCC,F1" and len(text) == 2
        rows[side] = text[1].split(",")
    assert rows["port"][0] == rows["jax"][0]
    np.testing.assert_allclose([float(x) for x in rows["port"][1:]],
                               [float(x) for x in rows["jax"][1:]], atol=METRIC_ATOL)


def test_tape_matches_jax(setup, tmp_path, monkeypatch):
    ckpt, tok, ban = setup
    rng = np.random.default_rng(0)
    base = tmp_path / "tape"
    (base / "fluorescence").mkdir(parents=True)
    (base / "secondary_structure").mkdir()
    for split, n in (("train", 12), ("valid", 6), ("test", 6)):
        data = [{"primary": _protein(rng, i % 2),
                 "log_fluorescence": [float(i % 2) * 2.0 + 0.1]} for i in range(n)]
        (base / "fluorescence" / f"fluorescence_{split}.json").write_text(json.dumps(data))
    for split, n in (("train", 12), ("valid", 6), ("casp12", 4), ("cb513", 4), ("ts115", 4)):
        data = []
        for i in range(n):
            seq = _protein(rng, i % 2)
            ss3 = [(0 if c == "A" else 1 if c == "W" else 2) for c in seq]
            data.append({"primary": seq, "ss3": ss3, "ss8": ss3})
        (base / "secondary_structure" / f"secondary_structure_{split}.json").write_text(
            json.dumps(data))
    kw = dict(banned_token=ban, tape_dir=str(base), output_suffix="t",
              tasks=["structure_ss3", "fluorescence"], num_epochs=2, batch_size=4, seed=0)
    _in(tmp_path / "jax", monkeypatch)
    want = jtape.run_tape(tok, ckpt, **kw)
    _in(tmp_path / "port", monkeypatch)
    jax_head_injector(monkeypatch, token_finetune, split=True)
    got = tape.run_tape(tok, ckpt, device="cpu", **kw)
    assert set(got) == {"casp12_ss3", "cb513_ss3", "ts115_ss3", "fluorescence"}
    _close_tree(got, want)
    _same_csv(tmp_path, "TAPE_t_results.csv")


def _same_csv(tmp_path, name, atol=METRIC_ATOL):
    rows = {side: [line.split(",") for line in
                   (tmp_path / side / name).read_text().splitlines()]
            for side in ("jax", "port")}
    assert [r[0] for r in rows["port"]] == [r[0] for r in rows["jax"]]
    np.testing.assert_allclose([float(r[1]) for r in rows["port"]],
                               [float(r[1]) for r in rows["jax"]], atol=atol)


def _write_pglue(eval_dir, rng):
    eval_dir.mkdir()
    for split, n in (("training", 12), ("validation", 6), ("test", 6)):
        lines = ["sequence,buried,solvent_accessibility"]
        for i in range(n):
            seq = _protein(rng, i % 2)
            lab = "[" + " ".join(str(0 if c == "A" else 1) for c in seq) + "]"
            asa = "[" + " ".join(f"{0.5 if c == 'W' else 0.1 * (i % 3)}" for c in seq) + "]"
            if split == "training" and i == 3:
                asa = "[0.1 0.2 ... 0.3]"   # an elided row: dropped from every column
            lines.append(f"{seq},\"{lab}\",\"{asa}\"")
        (eval_dir / f"asabu_{split}.csv").write_text("\n".join(lines) + "\n")


def test_proteinglue_matches_jax(setup, tmp_path, monkeypatch):
    ckpt, tok, ban = setup
    _write_pglue(tmp_path / "ProteinGLUE", np.random.default_rng(1))
    eval_dir = str(tmp_path / "ProteinGLUE")
    # the cleaning without pandas gives the pandas reading's datasets
    assert proteinglue.get_cleaned_evals(eval_dir, str(tmp_path / "p.pkl")) == \
        jpglue.get_cleaned_evals(eval_dir, str(tmp_path / "j.pkl"))
    kw = dict(banned_token=ban, eval_dir=eval_dir, output_suffix="t",
              tasks=["BUR", "ASA"], num_epochs=2, batch_size=4, seed=0, force_clean=True)
    _in(tmp_path / "jax", monkeypatch)
    want = jpglue.run_proteinglue(tok, ckpt, **kw)
    _in(tmp_path / "port", monkeypatch)
    jax_head_injector(monkeypatch, token_finetune, split=True)
    got = proteinglue.run_proteinglue(tok, ckpt, device="cpu", **kw)
    assert set(got) == {"BUR", "ASA"} and np.isfinite(got["ASA"])
    _close_tree(got, want, atol={"ASA": PCC_ATOL})
    _same_csv(tmp_path, "ProteinGLUE_t_results.csv", atol=PCC_ATOL)


def _pronab_files(root, rng):
    ds = {}
    for k in range(8):
        pep = "".join(rng.choice(list("MKVLAGIW"), size=16))
        ds[f"P{k}"] = {"Sequence": pep, "binding data": [
            ["".join(rng.choice(list("ACGT"), size=12)), "DNA" if k % 3 else "RNA",
             float(10 ** -rng.uniform(3, 9)), float(-rng.uniform(5, 15)), ""]]}
    ds["P0"]["binding data"].append(["ACGT", "DNA", 0, -8.0, ""])   # skipped
    (root / "pronab.json").write_text(json.dumps(ds))
    with open(root / "mut.jsonl", "w") as f:
        for k in range(4):
            pep = "".join(rng.choice(list("MKVLAGIW"), size=16))
            for _ in range(2):
                wild = "".join(rng.choice(list("ACGT"), size=12))
                f.write(json.dumps({
                    "peptide_sequence": pep,
                    "wild_nucleotide_sequence": f"<DNA>{wild}<EOS>",
                    "mutated_nucleotide_sequence": f"<DNA>{wild[:5]}T{wild[6:]}<EOS>",
                    "wild_G0": float(-rng.uniform(5, 15)),
                    "mutant_G0": float(-rng.uniform(5, 15))}) + "\n")


def _hold_pairs(got, want):
    """One ProNAB result: predictions as forwards are held, the metrics
    within what that tolerance moves them."""
    for key in ("ground_truths", "dG_ground_truths"):
        assert got[key] == want[key]
    for key in ("predictions", "dG_predictions"):
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL)
    slack = RTOL * max(abs(v) for v in want["dG_predictions"]) + ATOL
    for key in ("MAE", "dG_MAE"):
        assert abs(got[key] - want[key]) <= 2 * slack, (key, got[key], want[key])
    for key in ("pcc", "dG_pcc"):
        assert abs(got[key] - want[key]) <= 1e-3, (key, got[key], want[key])
    # the metrics are those of the predictions
    assert got["pcc"] == pytest.approx(pearsonr(got["ground_truths"], got["predictions"])[0])


def test_pronab_matches_jax(setup, tmp_path, monkeypatch):
    ckpt, tok, ban = setup
    _pronab_files(tmp_path, np.random.default_rng(0))
    kw = dict(pronab_json=str(tmp_path / "pronab.json"),
              mutation_jsonl=str(tmp_path / "mut.jsonl"), banned_tokens=[ban],
              num_epochs_pretrain=1, num_epochs_cv=2, num_accumulation_steps=8,
              micro_batch=4, folds=2, seed=0)
    _in(tmp_path / "jax", monkeypatch)
    want = jpronab.run_pronab(tok, ckpt, "t", **kw)
    _in(tmp_path / "port", monkeypatch)
    got = pronab.run_pronab(tok, ckpt, "t", device="cpu", **kw)
    assert len(got["folds"]) == len(want["folds"]) == 2
    for g, w in zip([got["zero_shot"], *got["folds"]], [want["zero_shot"], *want["folds"]]):
        _hold_pairs(g, w)
    lines = {side: [json.loads(x) for x in
                    open(tmp_path / side / "pronab-mutant-dual_t.jsonl")]
             for side in ("jax", "port")}
    assert len(lines["port"]) == 3
    for g, w in zip(lines["port"], lines["jax"]):
        _hold_pairs(g, w)
    pz = load_pytree_flat(str(tmp_path / "port" / "pronab_all_ft_t.npz"))
    with np.load(tmp_path / "jax" / "pronab_all_ft_t.npz") as jz:
        assert sorted(pz) == sorted(jz.files)
        for key in jz.files:   # one OneCycle pretraining step at lr <= 1e-2
            np.testing.assert_allclose(pz[key].numpy(), jz[key], atol=0.05 * 1e-2)


def test_pdb_contact_matches_jax(setup, tmp_path, monkeypatch):
    ckpt, tok, ban = setup
    sp = SentencePieceProcessor(tok)
    assert pdb_contact.process_sequence(sp, "MKVLAGIW", "ACGTACGT", [1, 0, 0, 1, 1, 0, 0, 1],
                                        [ban]) == \
        jpdb.process_sequence(sp, "MKVLAGIW", "ACGTACGT", [1, 0, 0, 1, 1, 0, 0, 1], [ban])
    rng = np.random.default_rng(1)
    data = []
    for _ in range(4):
        pep = "".join(rng.choice(list("MKVLAGIW"), size=14))
        for _ in range(3):
            data.append({"peptide_sequences": {"A": pep},
                         "nucleotide_sequences": {"B": "".join(rng.choice(list("ACGT"), size=10))},
                         "closest_nucleotides": rng.uniform(2, 20, size=14).tolist()})
    data.append({"peptide_sequences": {"A": "MKV"}, "nucleotide_sequences": {"B": "ACGT"},
                 "closest_nucleotides": [1.0, 2.0]})   # length mismatch: dropped
    (tmp_path / "dist.json").write_text(json.dumps(data))
    kw = dict(distances_json=str(tmp_path / "dist.json"), banned_tokens=[ban],
              num_epochs=2, num_accumulation_steps=8, micro_batch=4, folds=2, seed=0)
    _in(tmp_path / "jax", monkeypatch)
    want = jpdb.run_pdb_contact(ckpt, "t", tok, **kw)
    _in(tmp_path / "port", monkeypatch)
    jax_head_injector(monkeypatch, pdb_contact, split=False)
    got = pdb_contact.run_pdb_contact(ckpt, "t", tok, device="cpu", **kw)
    assert len(got) == 2 and all(0.0 <= r <= 1.0 for r in got)
    lines = {side: [json.loads(x) for x in open(tmp_path / side / "pdb_contact_eval_t.jsonl")]
             for side in ("jax", "port")}
    for g, w in zip(lines["port"], lines["jax"]):
        assert g["fold"] == w["fold"] and g["truths"] == w["truths"]
        np.testing.assert_allclose(g["preds"], w["preds"], rtol=RTOL, atol=ATOL)
    # ROC AUC ranks the probabilities: exact unless two swap within tolerance
    np.testing.assert_allclose(got, want, atol=METRIC_ATOL)


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The ArgumentParser a CLI's main() builds (stopped at parse_args)."""
    def capture(self, *a, **k):
        raise _Parsed(self)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed) as e:
            main([])
    return e.value.args[0]


@pytest.mark.parametrize("name", ["gue", "tape", "proteinglue", "pronab", "pdb_contact"])
def test_cli_flags_are_the_jax_ones_plus_device(name, monkeypatch):
    import importlib
    jp = _parser_of(importlib.import_module(f"omnibiote_tpu.evals.{name}").main, monkeypatch)
    pp = _parser_of(importlib.import_module(f"omnibiote_tpu_torch.evals.{name}").main, monkeypatch)
    flags = lambda p: {a.dest: (tuple(a.option_strings), a.nargs, a.type)
                       for a in p._actions if a.dest != "help"}
    want = flags(jp)
    want["device"] = (("--device",), None, None)
    assert flags(pp) == want
    defaults = lambda p: {a.dest: a.default for a in p._actions}
    # the JAX CLI's default tokenizer path is a file of its own host: here a
    # required flag
    skip = {"tokenizer_fn"} if name == "pdb_contact" else set()
    assert {k: v for k, v in defaults(pp).items() if k not in skip | {"device"}} == \
        {k: v for k, v in defaults(jp).items() if k not in skip}
