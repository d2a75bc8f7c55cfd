"""The port's tokenizer against the JAX package's on hand-built models.

`omnibiote_tpu_torch/tokenizer/cpp_test_util.py` writes the same ModelProto
bytes as the JAX helper; both packages' processors then load each model and
must agree on every encode and decode: BPE merges by score, control and
user-defined pieces, an unknown character, batch encoding and decoding an
ndarray. Both packages' BPE trainers, fast and naive, must write the same
model file for one seeded corpus. Nothing here reads the reference's
tokenizer files.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)

import numpy as np
import pytest

from omnibiote_tpu.tokenizer import SentencePieceProcessor as JaxProcessor
from omnibiote_tpu.tokenizer import cpp_test_util as jax_util
from omnibiote_tpu.tokenizer import train_bpe as jax_train_bpe
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor, train_bpe
from omnibiote_tpu_torch.tokenizer import cpp_test_util

MERGES = [("a", -10.0), ("b", -11.0), ("c", -12.0), ("ab", -1.0), ("bc", -2.0)]
BIO = ([(ch, -20.0 - i) for i, ch in enumerate("ACGTNMKVLS▁")]
       + [("AC", -3.0), ("GT", -3.5), ("ACGT", -1.0), ("▁A", -4.0), ("MK", -2.5),
          ("VL", -2.75), ("TT", -6.0), ("AA", -5.0)])
TAGS = ["<EOS>", "<DNA>", "<protein>"]
MODELS = {
    "merges": (MERGES, (), True),
    "bio": (BIO, TAGS, True),
    "bio_no_prefix": (BIO, TAGS, False),
    "unicode": ([("é", -1.0), ("ü", -2.0), ("éü", -0.5), ("▁", -3.0)], ("<x>",), True),
}


def _jax_model_bytes(monkeypatch, pieces, user_defined, prefix):
    """The file the JAX helper writes: its temporary file's name is taken
    from the NamedTemporaryFile it opens."""
    made = []
    real = jax_util.tempfile.NamedTemporaryFile

    def recording(*a, **kw):
        f = real(*a, **kw)
        made.append(f.name)
        return f

    monkeypatch.setattr(jax_util.tempfile, "NamedTemporaryFile", recording)
    sp = jax_util.build_model(list(pieces), list(user_defined), prefix)
    with open(made[-1], "rb") as f:
        return f.read(), sp


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """{name: (port processor, JAX processor)} of the same model file."""
    root = tmp_path_factory.mktemp("hand_built")
    out = {}
    for name, (pieces, user, prefix) in MODELS.items():
        path = root / f"{name}.model"
        path.write_bytes(cpp_test_util.model_bytes(pieces, user, prefix))
        out[name] = SentencePieceProcessor(str(path)), JaxProcessor(str(path))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_bytes_equal_the_jax_helper(name, monkeypatch):
    pieces, user, prefix = MODELS[name]
    want, jax_sp = _jax_model_bytes(monkeypatch, pieces, user, prefix)
    assert cpp_test_util.model_bytes(pieces, user, prefix) == want
    sp = cpp_test_util.build_model(list(pieces), user, prefix)
    assert sp.vocab_size() == jax_sp.vocab_size() == 3 + len(user) + len(pieces)
    assert ([sp.id_to_piece(i) for i in range(sp.vocab_size())]
            == [jax_sp.id_to_piece(i) for i in range(jax_sp.vocab_size())])


def test_merge_respects_scores(pairs):
    """Merges happen highest score first: 'ab' (-1) before 'bc' (-2); the
    dummy prefix '▁' is not in the vocabulary, so it is <unk>."""
    sp, jsp = pairs["merges"]
    ids = sp.encode("abc")
    assert [sp.id_to_piece(i) for i in ids][-2:] == ["ab", "c"]
    assert ids == jsp.encode("abc")
    assert sp.encode("bcab") == jsp.encode("bcab")


@pytest.mark.parametrize("name", ["bio", "bio_no_prefix", "unicode"])
def test_encode_decode_equal_jax(name, pairs):
    sp, jsp = pairs[name]
    texts = ["ACGT", "  ACGTACGT  ", "<DNA>ACGTTT<EOS>", "<protein>MKVL<EOS>",
             "AAACGT÷ACGT", "<s>ACGT</s>", "éüé ü", "NNNN<x>A"]
    for t in texts:
        ids = sp.encode(t)
        assert ids == jsp.encode(t), t
        assert sp.decode(ids) == jsp.decode(ids), t
        assert sp.encode(t, out_type=str) == jsp.encode(t, out_type=str), t
    for i in range(sp.vocab_size()):
        assert (sp.get_score(i), sp.piece_type(i), sp.is_control(i), sp.is_unknown(i)) \
            == (jsp.get_score(i), jsp.piece_type(i), jsp.is_control(i), jsp.is_unknown(i))


def test_control_and_user_defined_pieces(pairs):
    """User-defined tags match as single pieces; the control pieces <s>
    and </s> are never matched from text."""
    sp, jsp = pairs["bio"]
    ids = sp.encode("<protein>MK<EOS>")
    assert ids[-1] == sp.piece_to_id("<EOS>") == 3
    assert sp.piece_to_id("<protein>") in ids
    for t in ("<s>", "</s>", "<s>ACGT"):
        assert 1 not in sp.encode(t) and 2 not in sp.encode(t)
        assert sp.encode(t) == jsp.encode(t)
    assert sp.is_control(1) and sp.is_control(2) and sp.is_unknown(0)


def test_unknown_char(pairs):
    sp, jsp = pairs["bio"]
    ids = sp.encode("ACGT÷ACGT")
    assert sp.unk_id() in ids
    assert ids == jsp.encode("ACGT÷ACGT")


def test_batch_encode_matches_sequential_and_jax(pairs):
    sp, jsp = pairs["bio"]
    rng = np.random.default_rng(1)
    texts = ["".join(rng.choice(list("ACGTNMKVLS"), size=int(rng.integers(5, 120))))
             for _ in range(48)]
    batch = sp.encode_batch(texts, n_threads=4)
    jbatch = jsp.encode_batch(texts, n_threads=4)
    for t, ids, jids in zip(texts, batch, jbatch):
        assert list(ids) == sp.encode(t) == list(jids), t[:20]


def test_decode_ndarray(pairs):
    sp, jsp = pairs["bio"]
    row = sp.encode_batch(["<DNA>ACGTACGTAC<EOS>"])[0]
    assert isinstance(row, np.ndarray)
    assert sp.decode(row) == sp.decode(list(row)) == jsp.decode(row)


@pytest.mark.parametrize("naive", [False, True])
def test_train_bpe_writes_the_jax_model(naive, tmp_path):
    rng = np.random.default_rng(2)
    sents = [tag + "".join(rng.choice(list(alphabet), size=int(rng.integers(20, 60))))
             + "<EOS>"
             for tag, alphabet in (("<DNA>", "ACGT"), ("<protein>", "ACDEFGHIKLMNPQRSTVWY"))
             for _ in range(120)]
    ours, theirs = str(tmp_path / "port.model"), str(tmp_path / "jax.model")
    train_bpe(sents, vocab_size=160, out_path=ours, user_defined=TAGS, naive=naive)
    jax_train_bpe(sents, vocab_size=160, out_path=theirs, user_defined=TAGS, naive=naive)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    sp = SentencePieceProcessor(ours)
    assert sp.decode(sp.encode(sents[0])) == sents[0]
