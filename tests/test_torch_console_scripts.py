"""The port's console scripts (`pyproject.toml` `[project.scripts]`).

`pip install -e .[torch]` installs `obt-torch-train`, `obt-torch-encode`
and `obt-torch-train-bpe` beside the JAX package's `obt-*` scripts. A
console-script wrapper runs `sys.exit(main())`: an int or None is the exit
code, anything else is printed and exits 1. These tests read the packaging
with `tomllib`, then run each target in a subprocess exactly as the wrapper
does (`--help`, and the three scripts one after another on a tiny corpus on
the CPU), and check that none of them imports JAX."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import gzip
import json
import os
import subprocess
import sys
import tomllib

import numpy as np
import pytest

from omnibiote_tpu_torch.config import EOS_TOKEN

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SCRIPTS = {
    "obt-torch-train": "omnibiote_tpu_torch.training.cli:main",
    "obt-torch-encode": "omnibiote_tpu_torch.api:main",
    "obt-torch-train-bpe": "omnibiote_tpu_torch.tokenizer.train_cli:main",
}
JAX_SCRIPTS = {
    "obt-train": "omnibiote_tpu.training.cli:main",
    "obt-encode": "omnibiote_tpu.api:main",
    "obt-train-bpe": "omnibiote_tpu.tokenizer.train_cli:main",
}
# what a console-script wrapper does, and after it (at exit) whether JAX
# was imported
WRAPPER = """import atexit, re, sys
atexit.register(lambda: print("JAX_IMPORTED=" + str("jax" in sys.modules)))
from {module} import {attr}
sys.argv[0] = re.sub(r"(-script\\.pyw|\\.exe)?$", "", sys.argv[0])
sys.exit({attr}())
"""


@pytest.fixture(scope="module")
def project():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["project"]


def run_script(target, *args, cwd=None):
    module, attr = target.split(":")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", WRAPPER.format(module=module, attr=attr),
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd or ROOT, timeout=300)


def test_pyproject_names_the_port_scripts(project):
    """The three port scripts name the port's mains and no other script is
    new; the JAX scripts and dependencies are as they were; the `torch`
    extra holds torch and numpy; the port's package and its sources ship."""
    assert project["scripts"] == {**JAX_SCRIPTS, **PORT_SCRIPTS}
    assert project["dependencies"] == ["jax>=0.4.30", "numpy>=1.24", "optax>=0.2"]
    extra = project["optional-dependencies"]["torch"]
    assert sorted(e.split(">")[0].split("=")[0] for e in extra) == ["numpy", "torch"]
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        tool = tomllib.load(f)["tool"]["setuptools"]
    assert tool["packages"]["find"]["include"] == ["omnibiote_tpu*"]
    data = tool["package-data"]
    assert data["omnibiote_tpu_torch.ops"] == ["csrc/*.cu", "csrc/*.cuh"]
    assert data["omnibiote_tpu_torch.tokenizer"] == ["cpp/*.cc", "cpp/*.h"]


@pytest.mark.parametrize("name", sorted(PORT_SCRIPTS))
def test_help_exits_0_without_jax(name):
    """`<script> --help` through the wrapper: exit 0, the usage printed, and
    JAX never imported."""
    out = run_script(PORT_SCRIPTS[name], "--help")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "usage:" in out.stdout
    assert "JAX_IMPORTED=False" in out.stdout


def test_the_three_scripts_run_and_exit_0(tmp_path):
    """Train a BPE vocabulary, train one step over token shards and encode a
    FASTA file with the checkpoint and the vocabulary, each script through
    the wrapper on the CPU: every one exits 0 (a main that returned its
    Trainer or its output path exited 1), without JAX, and leaves its
    output."""
    rng = np.random.default_rng(0)
    corpus = tmp_path / "text"
    corpus.mkdir()
    seqs = ["".join(rng.choice(list("ACGT"), int(rng.integers(20, 80)))) for _ in range(120)]
    with gzip.open(corpus / "c.txt.gz", "wt") as f:
        f.write("".join("<DNA>" + s + "<EOS>" for s in seqs))
    tok = str(tmp_path / "bpe.model")
    out = run_script(PORT_SCRIPTS["obt-torch-train-bpe"], str(corpus / "*.txt.gz"), tok,
                     "--vocab_size", "64", "--user_defined", "<EOS>,<DNA>")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAX_IMPORTED=False" in out.stdout and os.path.getsize(tok) > 0

    data = tmp_path / "data"
    for corpus_dir in ("genbank/train", "uniref100/train", "genbank/val", "uniref100/val"):
        d = data / corpus_dir
        d.mkdir(parents=True)
        toks = rng.integers(20, 64, size=4000).astype(np.int32)
        toks[36::37] = EOS_TOKEN
        np.save(d / "s0.npy", toks)
    log = tmp_path / "m.jsonl"
    out = run_script(PORT_SCRIPTS["obt-torch-train"], "--base_dir", str(data),
                     "--n_layer", "1", "--n_embd", "64", "--n_head", "1", "--ctx_len",
                     "128", "--mini_batch_size", "2", "--batch_size", "2", "--max_steps",
                     "1", "--test_freq", "1e9", "--save_dir", str(tmp_path / "ck"),
                     "--metrics_jsonl", str(log), "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAX_IMPORTED=False" in out.stdout
    losses = [json.loads(line)["loss"] for line in log.read_text().splitlines()
              if "loss" in json.loads(line)]
    assert len(losses) == 1 and np.isfinite(losses[0])

    fasta = tmp_path / "s.fa"
    fasta.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs[:5])))
    emb = tmp_path / "e.npz"
    out = run_script(PORT_SCRIPTS["obt-torch-encode"], "--checkpoint",
                     str(tmp_path / "ck" / "omnibiota"), "--fasta", str(fasta), "--out",
                     str(emb), "--tag", "dna", "--tokenizer-path", tok, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "JAX_IMPORTED=False" in out.stdout
    got = np.load(emb)
    assert list(got["ids"]) == [f"r{i}" for i in range(5)]
    assert got["embeddings"].shape == (5, 64) and np.isfinite(got["embeddings"]).all()
