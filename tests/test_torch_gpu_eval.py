"""The card eval runner `tools/gpu_eval.py`: its fixture generators (the
layouts the families' loaders read, eval_tpu.py's separable tasks, the
seeded ProNAB records), the vocabulary's corpus, the quality-floor check on
made-up result rows, and that it refuses to run without a GPU unless asked
for the CPU. No family runs here.
"""
import csv
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import gpu_eval  # noqa: E402


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("gpu_eval"))
    return root, *gpu_eval.make_fixtures(root)


def test_fixture_layouts_are_what_the_loaders_read(fixtures):
    from omnibiote_tpu_torch.evals import contact, gue, pdb_contact, proteinglue, tape
    root, paths, _ = fixtures
    X, Y, Xv, Yv, Xt, Yt = gue.load_task(os.path.join(paths["gue"], "tf", "0"))
    assert (len(X), len(Xv), len(Xt)) == (64, 32, 32)
    assert all(x.startswith("GGGGCCGGGGCC" if int(y) else "ATATATATATAT")
               for x, y in zip(X, Y))
    with open(os.path.join(paths["pglue"], "ss_training.csv")) as f:
        rows = list(csv.reader(f))[1:]
    assert len(rows) == 40
    for seq, lab in rows:
        labels = [int(v) for v in lab.strip("[]").split()]
        assert labels == [0 if c == "A" else 1 if c == "W" else 2 for c in seq]
    assert set(os.listdir(paths["pglue"])) == {
        "ss_training.csv", "ss_validation.csv", "ss_test.csv", "ss_cb513_test.csv"}
    seqs, vals = tape.load_scalar_task("fluorescence", "train", paths["tape"],
                                       "log_fluorescence")
    assert len(seqs) == 48 and set(np.round(vals, 6)) == {0.1, 2.1}
    n_pdb = len(pdb_contact.load_distance_data(paths["pdb"])[0])
    assert n_pdb == 18
    assert hasattr(proteinglue, "run_proteinglue")
    # contact: the contacts are exactly the W-W pairs at any separation
    seqs, cmaps, masks, med, long_ = contact.load_proteinnet("train", paths["contact"])
    assert len(seqs) == 10
    for s, cm in zip(seqs, cmaps):
        w = np.array([c == "W" for c in s])
        np.testing.assert_array_equal(cm, w[:, None] & w[None, :] | np.eye(len(s), dtype=bool))


def test_pronab_records_are_seeded_and_learnable(fixtures, tmp_path):
    root, paths, _ = fixtures
    with open(paths["pronab"]) as f:
        ds = json.load(f)
    again, _ = gpu_eval.make_pronab(str(tmp_path / "again.json"))
    with open(again) as f:
        assert json.load(f) == ds
    assert len(ds) == 40
    gc, g0 = [], []
    for v in ds.values():
        assert 50 <= len(v["Sequence"]) < 400
        for nuc, kind, kd, dg, _ in v["binding data"]:
            assert kind in ("DNA", "RNA") and 0 < kd < 1 and set(nuc) <= set("ACGT")
            gc.append(sum(c in "GC" for c in nuc) / len(nuc))
            g0.append(dg)
    assert np.corrcoef(gc, g0)[0, 1] < -0.9
    with open(paths["mutations"]) as f:
        pairs = [json.loads(line) for line in f]
    peptides = {v["Sequence"] for v in ds.values()}
    assert len(pairs) == 18 and all(p["peptide_sequence"] in peptides for p in pairs)
    for p in pairs:
        wild = p["wild_nucleotide_sequence"][5:-5]
        mut = p["mutated_nucleotide_sequence"][5:-5]
        assert len(wild) == len(mut) == 14 and sum(a != b for a, b in zip(wild, mut)) == 1


def test_vocabulary_corpus_covers_every_family(fixtures):
    _, paths, corpus = fixtures
    proteins = [s for s in corpus if s.startswith("<protein>")]
    dna = [s for s in corpus if s.startswith("<DNA>")]
    assert len(proteins) + len(dna) == len(corpus) and all(s.endswith("<EOS>") for s in corpus)
    assert any(set(s[9:-5]) <= set("AWLV") for s in proteins)        # SS3 / fluorescence
    assert any(set(s[9:-5]) <= set("MKVLAGIW") for s in proteins)    # contact / PDB
    assert any(s[5:].startswith("GGGGCCGGGGCC") for s in dna)        # GUE
    assert sum(len(s) > 60 for s in proteins) >= 40                  # ProNAB peptides


def test_checkpoint_is_eval_tpus_model(tmp_path):
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
    path = gpu_eval.write_checkpoint(str(tmp_path / "ck"), torch.device("cpu"))
    model, cfg = load_model_checkpoint(path, device="cpu")
    assert (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.head_dim, cfg.block_size,
            cfg.compute_dtype, cfg.vocab_size) == (2, 256, 2, 128, 1024, "bfloat16", 65536)


def _row(task, value):
    return {"task": task, "metric": "m", "value": value}


def test_floor_check():
    ok = [_row("GUE GUE/tf/0 (synthetic motif)", 0.3), _row("ProteinGLUE SS3 (x)", 0.9),
          _row("TAPE fluorescence (x)", -1.0), _row("TAPE contact (x)", 0.1),
          _row("ProNAB dual-loss (x)", 9.0), _row("PDB contact (x)", 0.61),
          _row("DeePNAP baseline (x)", 0.0)]
    assert gpu_eval.check_floors(ok) == []
    bad = [_row("GUE GUE/tf/0 (synthetic motif)", 0.29), _row("ProteinGLUE SS3 (x)", 0.3),
           _row("TAPE contact (x)", float("nan")), _row("PDB contact (x)", 0.5)]
    failures = gpu_eval.check_floors(bad)
    assert len(failures) == 4
    assert failures[0] == "GUE GUE/tf/0 (synthetic motif): MCC 0.29 < floor 0.3"
    assert "medium+long AUPRC nan < floor 0.1" in failures[2]


def test_refuses_without_a_gpu_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = tmp_path / "EVAL_GPU.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpu_eval.main(["--out", str(out)])
    assert not out.exists()
