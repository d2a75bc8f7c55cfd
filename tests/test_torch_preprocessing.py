"""PyTorch port vs the JAX package: the corpus tools (raw GenBank / UniRef
records -> tagged text -> BPE vocabulary -> token shards) give the same
outputs byte for byte from the same inputs.

Inputs are synthetic, from a numpy seed: GenBank flat files with LOCUS /
ORIGIN records of several molecule types (strandedness attached and
apart, a protein record, a record without ORIGIN, a record without a
molecule type), a UniRef-style FASTA with multi-line records and no
newline after the last one, and a fake FTP server for the mirror. Gzip
members carry a timestamp, so `.gz` outputs are compared decompressed;
`.npy` shards and `.model` files are compared as written."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import ftplib
import glob
import gzip
import os

import numpy as np
import pytest

from omnibiote_tpu.preprocessing import download as jax_download
from omnibiote_tpu.preprocessing import genbank as jax_genbank
from omnibiote_tpu.preprocessing import tokenize_corpus as jax_tokenize
from omnibiote_tpu.preprocessing import uniprot as jax_uniprot
from omnibiote_tpu.tokenizer import SentencePieceProcessor as JaxSP
from omnibiote_tpu.tokenizer import train_cli as jax_train_cli

from omnibiote_tpu_torch.preprocessing import download as port_download
from omnibiote_tpu_torch.preprocessing import genbank as port_genbank
from omnibiote_tpu_torch.preprocessing import tokenize_corpus as port_tokenize
from omnibiote_tpu_torch.preprocessing import uniprot as port_uniprot
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor as PortSP
from omnibiote_tpu_torch.tokenizer import train_bpe
from omnibiote_tpu_torch.tokenizer import train_cli as port_train_cli

MOLECULES = [("DNA", ""), ("mRNA", ""), ("RNA", "ss-"), ("DNA", "ds-"), ("rRNA", "ss- "),
             ("cRNA", ""), ("tRNA", "ms-")]


def _origin(seq):
    lines = ["ORIGIN      "]
    for i in range(0, len(seq), 60):
        chunk = " ".join(seq[j:j + 10] for j in range(i, min(i + 60, len(seq)), 10))
        lines.append(f"{i + 1:>9} {chunk.lower()}")
    return lines


def genbank_text(rng, n_records):
    """A flat file of n_records records plus the odd ones the parser must
    drop (no ORIGIN, no molecule type) and one protein record."""
    lines = []
    for r in range(n_records):
        mol, strand = MOLECULES[r % len(MOLECULES)]
        alphabet = "ACGU" if "RNA" in mol else "ACGT"
        seq = "".join(rng.choice(list(alphabet), size=int(rng.integers(20, 300))))
        lines += [f"LOCUS       SEQ{r:05d}   {len(seq)} bp    {strand}{mol}     linear   "
                  "VRL 01-JAN-2000", "DEFINITION  synthetic record.",
                  "FEATURES             Location/Qualifiers", *_origin(seq), "//"]
    lines += ["LOCUS       NOORIGIN     30 bp    DNA     linear   VRL 01-JAN-2000", "//",
              "LOCUS       NOTYPE", *_origin("ACGTACGTAC"), "//",
              "LOCUS       PROT01      12 aa            linear   PRI 01-JAN-2000",
              *_origin("MKVLAAGIVGHE"), "//"]
    return "\n".join(lines) + "\n"


def fasta_text(rng, n_records):
    out = []
    for r in range(n_records):
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), size=int(rng.integers(10, 200))))
        out.append(f">UniRef100_P{r:05d} synthetic n=1 Tax=X\n"
                   + "\n".join(seq[i:i + 60] for i in range(0, len(seq), 60)))
    return "\n".join(out)          # no newline after the last record


def _gunzip(path):
    with gzip.open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    rng = np.random.default_rng(0)
    for i in range(2):
        with gzip.open(root / f"gbvrl{i + 1}.seq.gz", "wt") as f:
            f.write(genbank_text(rng, 40))
    with gzip.open(root / "uniref100.fasta.gz", "wt") as f:
        f.write(fasta_text(rng, 150))
    return root


def test_parse_genbank_records_match(raw):
    text = _gunzip(raw / "gbvrl1.seq.gz").decode()
    got = list(port_genbank.parse_genbank_records(iter(text.splitlines(True))))
    want = list(jax_genbank.parse_genbank_records(iter(text.splitlines(True))))
    assert got == want
    assert len(got) == 41 and {m for m, _ in got} >= {"DNA", "mRNA", "ss-RNA", "ds-DNA",
                                                      "ss-rRNA", "ms-tRNA", "linear"}


def test_genbank_main_and_process_seq_gz_match(raw, tmp_path):
    outs = {}
    for name, mod in (("jax", jax_genbank), ("port", port_genbank)):
        d = tmp_path / name
        counts = mod.main(str(raw), str(d), workers=1)
        files = sorted(os.listdir(d))
        outs[name] = counts, files, [_gunzip(d / f) for f in files]
        # a second run skips the files already written
        assert mod.main(str(raw), str(d), workers=1) == {}
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == ["gbvrl1.txt.gz", "gbvrl2.txt.gz"]
    one = tmp_path / "one"
    one.mkdir()
    for name, mod in (("jax", jax_genbank), ("port", port_genbank)):
        d = one / name
        d.mkdir()
        outs[name] = mod.process_seq_gz(str(raw / "gbvrl2.seq.gz"), str(d)), \
            _gunzip(d / "gbvrl2.txt.gz")
    assert outs["port"] == outs["jax"]


def test_uniprot_main_matches(raw, tmp_path):
    """A chunk size of 2 kB splits records across reads and shards; the
    trailing record (no newline) is kept by both."""
    shards = {}
    for name, mod in (("jax", jax_uniprot), ("port", port_uniprot)):
        d = tmp_path / name
        n = mod.main(str(raw / "uniref100.fasta.gz"), str(d), chunk_size=2048)
        shards[name] = n, [_gunzip(p) for p in sorted(glob.glob(str(d / "*.txt.gz")))]
    assert shards["port"] == shards["jax"]
    n, texts = shards["port"]
    assert n == len(texts) > 3
    assert b"".join(texts).count(b"<EOS>") == 150


class FakeFTP:
    """An offline FTP double: `files` on the server, the first RETR of each
    name in `flaky` fails with a transient error, and the first reconnect
    after it fails too."""

    def __init__(self, files, flaky, log):
        self.files, self.flaky, self.log = files, set(flaky), log
        self.reconnect_fails = set(flaky)

    def __call__(self, address):
        if self.log and self.log[-1] == "retry" and self.reconnect_fails:
            self.reconnect_fails.pop()
            raise EOFError("connection refused")
        self.log.append(f"connect {address}")
        return self

    def login(self):
        self.log.append("login")

    def cwd(self, d):
        self.log.append(f"cwd {d}")

    def nlst(self):
        return sorted(self.files) + ["README"]

    def voidcmd(self, cmd):
        pass

    def size(self, name):
        return len(self.files[name])

    def retrbinary(self, cmd, callback):
        name = cmd.split()[1]
        callback(self.files[name][:5])
        if name in self.flaky:
            self.flaky.discard(name)
            self.log.append("retry")
            raise ftplib.error_temp("421 timeout")
        callback(self.files[name][5:])


def test_download_mirror_resume_and_retry_match(tmp_path, monkeypatch):
    """A fresh mirror with one transient failure (and a failed reconnect),
    then a resumed one: complete files are skipped, a truncated one is
    fetched again from byte 0; retries give up after max_retries."""
    monkeypatch.setattr(jax_download.time, "sleep", lambda s: None)
    monkeypatch.setattr(port_download.time, "sleep", lambda s: None)
    rng = np.random.default_rng(5)
    files = {f"gbvrl{i}.seq.gz": rng.bytes(int(rng.integers(10, 400))) for i in range(4)}
    runs = {}
    for name, mod in (("jax", jax_download), ("port", port_download)):
        dest = tmp_path / name
        events, msgs = [], []
        kw = dict(dest_dir=str(dest), retry_delay=0.0, log=msgs.append)
        first = mod.download_seq_files("ftp.example", "/genbank", ".seq.gz",
                                       ftp_factory=FakeFTP(files, ["gbvrl1.seq.gz"], events),
                                       **kw)
        with open(dest / "gbvrl2.seq.gz", "wb") as f:
            f.write(b"trunc")
        second = mod.download_seq_files("ftp.example", "/genbank", ".seq.gz",
                                        ftp_factory=FakeFTP(files, [], events), **kw)
        third = mod.download_seq_files(
            "ftp.example", "/genbank", ".seq.gz", max_retries=2,
            ftp_factory=FakeFTP({"x.seq.gz": b"0123456789"}, ["x.seq.gz"] * 3, events), **kw)
        got = {f: (dest / f).read_bytes() for f in sorted(os.listdir(dest))}
        runs[name] = first, second, third, events, msgs, got
    assert runs["port"] == runs["jax"]
    first, second, _, _, _, got = runs["port"]
    assert first == sorted(files) and second == ["gbvrl2.seq.gz"]
    assert all(got[f] == files[f] for f in files)


@pytest.fixture(scope="module")
def tagged(raw, tmp_path_factory):
    """The genbank and uniprot tagged text, and a BPE vocabulary trained on
    it by the port's train_bpe."""
    root = tmp_path_factory.mktemp("tagged")
    port_genbank.main(str(raw), str(root / "genbank"), workers=1)
    port_uniprot.main(str(raw / "uniref100.fasta.gz"), str(root / "uniref100"),
                      chunk_size=4096)
    texts = [_gunzip(p).decode() for p in sorted(glob.glob(str(root / "*" / "*.txt.gz")))]
    sentences = [r + "<EOS>" for t in texts for r in t.split("<EOS>") if r]
    tok = str(root / "bpe.model")
    train_bpe(sentences, vocab_size=300, out_path=tok,
              user_defined=port_train_cli.DEFAULT_USER_DEFINED.split(","))
    return root, tok


def test_tokenize_to_shards_matches(tagged, tmp_path):
    root, tok = tagged
    paths = sorted(glob.glob(str(root / "*" / "*.txt.gz")))
    results = {}
    for name, mod, sp in (("jax", jax_tokenize, JaxSP(tok)), ("port", port_tokenize, PortSP(tok))):
        out = tmp_path / name
        stats = mod.tokenize_to_shards(paths, str(out), sp, shard_tokens=3000,
                                       val_fraction=0.1, batch_records=64, n_threads=2,
                                       seed=3)
        shards = {os.path.relpath(p, out): open(p, "rb").read()
                  for p in sorted(glob.glob(str(out / "*" / "*.npy")))}
        results[name] = stats, shards
    assert results["port"] == results["jax"]
    stats, shards = results["port"]
    assert stats["train_shards"] > 1 and stats["val_shards"] >= 1
    assert stats["records"] == 82 + 150


def test_train_cli_matches(tagged, tmp_path):
    root, _ = tagged
    glob_arg = str(root / "*" / "*.txt.gz")
    models = {}
    for name, mod in (("jax", jax_train_cli), ("port", port_train_cli)):
        out = str(tmp_path / f"{name}.model")
        assert mod.main([glob_arg, out, "--vocab_size", "280", "--max_sentences",
                         "200"]) == out
        models[name] = open(out, "rb").read()
    assert models["port"] == models["jax"]
    assert PortSP(str(tmp_path / "port.model")).vocab_size() == 280
