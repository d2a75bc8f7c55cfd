"""PyTorch port vs the JAX package: the DeePNAP baseline
(`evals/deepnap.py`).

The encoders exactly; the DeePNAP CNN against `apply_deepnap` with the same
weights (forward and `jax.grad`, rtol 2e-4 / atol 2e-5); the port's
dropout (keep rate, one mask per seed); and `run_deepnap` end to end
through both packages on one seeded ProNAB fixture, the JAX init carried
over and the pretraining's dropout patched out of both packages'
`apply_deepnap` (TPU streams cannot be matched): the zero-shot and fold
metrics (to 1e-5: fp32 predictions in G0 units) and the jsonl lines. And
the CLI's flags.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnibiote_tpu.evals import deepnap as jdeepnap
from omnibiote_tpu_torch.evals import deepnap
from omnibiote_tpu_torch.utils.convert import deepnap_state_from_jax

from test_torch_eval_common import ATOL, RTOL
from test_torch_eval_families import PCC_ATOL, _parser_of


def _port_model(jparams):
    model = deepnap.DeePNAP(device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in deepnap_state_from_jax(jparams).items()})
    return model


def test_encoders_match_jax():
    rng = np.random.default_rng(0)
    peptides = ["M", "mkvLAGiw", "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWYXBZ"), 1200)),
                "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 300))]
    for p in peptides:
        got, want = deepnap.encode_peptide(p), jdeepnap.encode_peptide(p)
        assert got.shape == (1000, 9) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    nucleotides = ["", "acgtu", "ACGTNRY" * 5, "".join(rng.choice(list("ACGTU"), 120)),
                   "AC-GT.TT"]
    for n in nucleotides:
        got, want = deepnap.encode_nucleotide(n), jdeepnap.encode_nucleotide(n)
        assert got.shape == (75, 5) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def _inputs(rng, B):
    xp = np.stack([jdeepnap.encode_peptide("".join(rng.choice(
        list("ACDEFGHIKLMNPQRSTVWY"), int(rng.integers(20, 1000)))))[None] for _ in range(B)])
    xn = np.stack([jdeepnap.encode_nucleotide("".join(rng.choice(
        list("ACGT"), int(rng.integers(10, 75)))))[None] for _ in range(B)])
    return xp, xn


def test_deepnap_matches_jax():
    rng = np.random.default_rng(1)
    jparams = jdeepnap.init_deepnap(jax.random.PRNGKey(3))
    model = _port_model(jparams)
    xp, xn = _inputs(rng, 5)
    w = rng.standard_normal((5, 1)).astype(np.float32)
    want = jax.jit(jdeepnap.apply_deepnap)(jparams, jnp.asarray(xp), jnp.asarray(xn))
    got = deepnap.apply_deepnap(model, torch.from_numpy(xp), torch.from_numpy(xn))
    assert got.shape == (5, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    jgrad = jax.jit(jax.grad(lambda p: jnp.sum(
        jdeepnap.apply_deepnap(p, jnp.asarray(xp), jnp.asarray(xn)) * w)))(jparams)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = deepnap_state_from_jax(jgrad)
    named = dict(model.named_parameters())
    assert set(named) == set(want_g)
    for k, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_init_and_dropout():
    a = deepnap.init_deepnap(torch.Generator().manual_seed(0))
    b = deepnap.init_deepnap(torch.Generator().manual_seed(0))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    jshapes = {k: np.shape(v) for k, v in
               deepnap_state_from_jax(jdeepnap.init_deepnap(jax.random.PRNGKey(0))).items()}
    assert {k: tuple(v.shape) for k, v in sa.items()} == jshapes
    for name, fan_in in (("protein_conv1", 54), ("dna_conv2", 10), ("int_p2_n1.0", 207),
                         ("fc1", 128), ("fc4", 64)):
        w = sa[f"{name}.weight"]
        assert w.abs().max() <= fan_in ** -0.5 and sa[f"{name}.bias"].abs().max() <= fan_in ** -0.5
        assert w.abs().max() > 0.9 * fan_in ** -0.5
    # dropout after fc1 and fc2: one mask a seed, none without a seed
    xp, xn = (torch.from_numpy(x) for x in _inputs(np.random.default_rng(2), 64))
    with torch.no_grad():
        plain = a(xp, xn)
        assert torch.equal(a(xp, xn, 0.5, None), plain)
        d1, d2, d3 = (a(xp, xn, 0.5, s) for s in (7, 7, 8))
    assert torch.equal(d1, d2) and not torch.equal(d1, d3) and not torch.equal(d1, plain)
    res = []
    a.fc2.register_forward_hook(lambda m, i, o: res.append(i[0]))
    with torch.no_grad():
        a(xp, xn, 0.5, 11)
    kept = (res[0] != 0).float().mean().item()
    assert 0.45 < kept < 0.55


def _fixtures(root, seed=0):
    """A ProNAB dict (8 proteins, a few binding rows each) and mutation
    pairs over 4 peptides (2 of them also in the ProNAB dict, which
    decontamination then drops), the mutant a fresh nucleotide string: a
    ddG of two near-equal predictions would make its Pearson's r a ratio
    of rounding errors."""
    rng = np.random.default_rng(seed)
    pep = lambda: "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(rng.integers(30, 200))))
    nuc = lambda n: "".join(rng.choice(list("ACGT"), n))
    peptides = [pep() for _ in range(10)]
    ds = {}
    for k, p in enumerate(peptides[:8]):
        rows = []
        for _ in range(int(rng.integers(3, 7))):
            rows.append([nuc(int(rng.integers(10, 40))), "RNA" if rng.random() < 0.3 else "DNA",
                         float(10 ** -rng.uniform(3, 9)), float(-rng.uniform(5, 15)), ""])
        rows.append([nuc(12), "DNA", 0.0, -8.0, ""])      # dropped: Kd 0
        ds[f"P{k}"] = {"Sequence": p, "binding data": rows}
    pronab = os.path.join(root, "pronab.json")
    with open(pronab, "w") as f:
        json.dump(ds, f)
    mutations = os.path.join(root, "mutation_data.jsonl")
    with open(mutations, "w") as f:
        for p in peptides[6:]:
            for _ in range(3):
                f.write(json.dumps({
                    "peptide_sequence": p,
                    "wild_nucleotide_sequence": f"<DNA>{nuc(20)}<EOS>",
                    "mutated_nucleotide_sequence": f"<DNA>{nuc(int(rng.integers(10, 60)))}<EOS>",
                    "wild_G0": float(-rng.uniform(5, 15)),
                    "mutant_G0": float(-rng.uniform(5, 15))}) + "\n")
    return pronab, mutations


def test_run_deepnap_matches_jax(tmp_path, monkeypatch):
    pronab, mutations = _fixtures(str(tmp_path))
    kw = dict(output_suffix="t", num_epochs=8, batch_size=16, folds=3, num_epochs_cv=8,
              seed=2)
    orig_j, orig_p = jdeepnap.apply_deepnap, deepnap.apply_deepnap
    monkeypatch.setattr(jdeepnap, "apply_deepnap", lambda p, xp, xn, **k: orig_j(p, xp, xn))
    monkeypatch.setattr(deepnap, "apply_deepnap", lambda m, xp, xn, **k: orig_p(m, xp, xn))
    monkeypatch.setattr(deepnap, "init_deepnap", lambda gen, device=None: _port_model(
        jdeepnap.init_deepnap(jax.random.PRNGKey(gen.initial_seed()))).to(device))
    results, lines = {}, {}
    for side, run in (("jax", lambda: jdeepnap.run_deepnap(pronab, mutations, **kw)),
                      ("port", lambda: deepnap.run_deepnap(pronab, mutations, device="cpu",
                                                           **kw))):
        os.makedirs(tmp_path / side)
        monkeypatch.chdir(tmp_path / side)
        results[side] = run()
        with open(tmp_path / side / "deepnap-mutant-dual_t.jsonl") as f:
            lines[side] = [json.loads(line) for line in f]
    got, want = results["port"], results["jax"]
    assert len(got["folds"]) == len(want["folds"]) == 3
    assert lines["port"] == [got["zero_shot"], *got["folds"]]
    assert len(lines["jax"]) == len(lines["port"])
    for g, w in zip(lines["port"], lines["jax"]):
        assert set(g) == set(w) == {"pcc", "MAE", "dG_pcc", "dG_MAE"}
        # G0 predictions are fp32 of |G0| <= 15, whose ulp is 9.5e-7: the
        # MAEs and Pearson's r of two runs that differ in the order of fp32
        # sums move by a few of those
        for k in g:
            assert abs(g[k] - w[k]) <= PCC_ATOL, (k, g[k], w[k])


def test_cli_flags_are_the_jax_ones_plus_device(monkeypatch):
    jp, pp = _parser_of(jdeepnap.main, monkeypatch), _parser_of(deepnap.main, monkeypatch)
    flags = lambda p: {a.dest: (tuple(a.option_strings), a.nargs, a.type, a.default)
                       for a in p._actions if a.dest != "help"}
    want = flags(jp)
    want["device"] = (("--device",), None, None, None)
    assert flags(pp) == want


def test_entry_point_needs_a_gpu_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    pronab, mutations = _fixtures(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deepnap.main(["--pronab_json", pronab, "--mutation_jsonl", mutations])
    got = deepnap.main(["--pronab_json", pronab, "--mutation_jsonl", mutations,
                        "--num_epochs", "1", "--device", "cpu"])
    assert len(got["folds"]) == 4   # 4 peptide groups, 10 folds
