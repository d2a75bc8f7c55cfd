"""PyTorch port vs the JAX package: the serving API (`Encoder`, the FASTA
CLI, the tokenizer), and the port's isolation from JAX and from the CPU.

Both packages read one checkpoint written by the JAX Trainer (fp32 compute,
one head of 128 so that both dispatches take the flash path: the Pallas
kernel in interpret mode, and the port's plain version of its CUDA kernel)
and one BPE vocabulary trained by `train_bpe`. Tolerance rtol 2e-4 /
atol 2e-5, as in tests/test_model_parity.py.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import ast
import os

import numpy as np
import pytest
import torch

import omnibiote_tpu as obt
from omnibiote_tpu.api import Encoder as JaxEncoder, main as jax_main
from omnibiote_tpu.tokenizer import (
    SentencePieceProcessor as JaxSP, train_bpe as jax_train_bpe)

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch import api as port_api
from omnibiote_tpu_torch.ops import _kernels
from omnibiote_tpu_torch.ops import flash_attention as port_flash
from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor, train_bpe
from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint

RTOL, ATOL = 2e-4, 2e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQS = ["<DNA>ACGTACGTAGGCT", "<protein>MKVLAAGIWQRST",
        "<DNA>" + "ACGTTGCA" * 30, "<protein>" + "MKWVTFISLL" * 9,
        "<DNA>GATTACA"]


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    sents = []
    for i in range(300):
        if i % 2:
            body = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"),
                                      size=int(rng.integers(20, 60))))
            sents.append("<protein>" + body + "<EOS>")
        else:
            body = "".join(rng.choice(list("ACGT"), size=int(rng.integers(20, 60))))
            sents.append("<DNA>" + body + "<EOS>")
    return sents


SPECIALS = ["<EOS>", "<DNA>", "<protein>"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(checkpoint dir, tokenizer path) shared by both packages."""
    from omnibiote_tpu import TrainConfig
    from omnibiote_tpu.training.train import Trainer
    root = tmp_path_factory.mktemp("serve")
    tok = str(root / "toy.model")
    train_bpe(_corpus(), vocab_size=200, out_path=tok, user_defined=SPECIALS)
    cfg = obt.OmniBioTAConfig(n_layer=2, n_head=1, n_embd=128, vocab_size=512,
                              block_size=256, dropout=0.0, attn_impl="flash",
                              compute_dtype="float32")
    tc = TrainConfig(batch_size=8, mini_batch_size=1, ctx_len=256,
                     token_budget=1e9, save_dir=str(root / "ck"), save_name="m")
    ckpt = Trainer(cfg, tc, batch_iter=iter(())).save_checkpoint(final=True)
    return ckpt, tok


@pytest.fixture(scope="module")
def encoders(served):
    ckpt, tok = served
    return (JaxEncoder.from_checkpoint(ckpt, tokenizer_path=tok),
            port_api.Encoder.from_checkpoint(ckpt, tokenizer_path=tok,
                                             device="cpu"))


@pytest.mark.parametrize("mask_padding", [True, False], ids=["masked", "leaky"])
@pytest.mark.parametrize("method", ["mean", "first", "last", "max"])
def test_encoder_matches_jax(encoders, method, mask_padding):
    jenc, penc = encoders
    kw = dict(method=method, batch_size=2, mask_padding=mask_padding)
    want = jenc.encode_sequences(SEQS, **kw)
    got = penc.encode_sequences(SEQS, **kw)
    assert got.shape == want.shape == (len(SEQS), 128)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_encoder_rejects_all_pooling(encoders):
    with pytest.raises(ValueError, match="unknown pooling"):
        encoders[1].encode_sequences(SEQS, method="all")
    assert encoders[1].encode_sequences([], method="mean").shape == (0, 128)


def test_tokenizer_matches_jax(served, tmp_path):
    """The port's copy of the tokenizer trains the same .model bytes and
    encodes to the same ids as the JAX package's."""
    _, tok = served
    other = str(tmp_path / "jax.model")
    jax_train_bpe(_corpus(), vocab_size=200, out_path=other,
                  user_defined=SPECIALS)
    with open(tok, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    psp, jsp = SentencePieceProcessor(tok), JaxSP(tok)
    assert psp.vocab_size() == jsp.vocab_size()
    for s in SEQS:
        assert psp.encode(s) == jsp.encode(s)
        assert psp.decode(psp.encode(s)) == s
    for a, b in zip(psp.encode_batch(SEQS), jsp.encode_batch(SEQS)):
        np.testing.assert_array_equal(a, b)


def test_fasta_cli_matches_jax(served, tmp_path):
    ckpt, tok = served
    fasta = tmp_path / "in.fa"
    fasta.write_text("".join(f">r{i} some header\n{s[:40]}\n{s[40:]}\n"
                             for i, s in enumerate(SEQS)))
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_api.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.npz")
        assert main(["--checkpoint", ckpt, "--fasta", str(fasta), "--out", out,
                     "--tokenizer-path", tok, "--batch-size", "2", *extra]) == 0
        outs[name] = np.load(out)
    np.testing.assert_array_equal(outs["port"]["ids"], outs["jax"]["ids"])
    assert list(outs["port"]["ids"]) == [f"r{i}" for i in range(len(SEQS))]
    np.testing.assert_allclose(outs["port"]["embeddings"],
                               outs["jax"]["embeddings"], rtol=RTOL, atol=ATOL)


def test_fasta_cli_data_parallel_matches_jax(served, tmp_path):
    """--data-parallel runs: the port's CLI on a mesh of this one process
    (rows split over its data axis, gathered back) against the JAX CLI on
    one device (its --data-parallel runs the Pallas kernels in interpret
    mode through a callback that XLA's partitioner refuses on the CPU;
    tests/test_api.py holds its mesh result equal to one device's)."""
    ckpt, tok = served
    fasta = tmp_path / "in.fa"
    fasta.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(SEQS)))
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_api.main, ["--device", "cpu", "--data-parallel"])):
        out = str(tmp_path / f"{name}.npz")
        assert main(["--checkpoint", ckpt, "--fasta", str(fasta), "--out", out,
                     "--tokenizer-path", tok, "--batch-size", "3", *extra]) == 0
        outs[name] = np.load(out)
    np.testing.assert_array_equal(outs["port"]["ids"], outs["jax"]["ids"])
    np.testing.assert_allclose(outs["port"]["embeddings"],
                               outs["jax"]["embeddings"], rtol=RTOL, atol=ATOL)


def test_iter_fasta_matches_jax(tmp_path):
    import gzip
    from omnibiote_tpu.api import iter_fasta as jax_iter
    path = str(tmp_path / "x.fa.gz")
    with gzip.open(path, "wt") as f:
        f.write(">a desc\nACGT\nTT\n\n>b\nMKV\n>\nQQ\n")
    assert list(port_api.iter_fasta(path)) == list(jax_iter(path)) == [
        ("a", "ACGTTT"), ("b", "MKV"), ("", "QQ")]


def test_unported_options_raise(served):
    """mesh= is ported (tests/test_torch_parallel.py runs it over 4 ranks):
    what it takes is a DeviceMesh, and anything else raises."""
    ckpt, tok = served
    model, _ = load_model_checkpoint(ckpt, device="cpu")
    sp = SentencePieceProcessor(tok)
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_api.Encoder(model, sp, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        port_api.Encoder(model, sp, quantize=True, mesh=object(), device="cpu")


# ---------------------------------------------------------------------------
# int8 serving
# ---------------------------------------------------------------------------

def _row_cosine(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("mask_padding", [True, False], ids=["masked", "leaky"])
@pytest.mark.parametrize("quantize_attention", [False, True],
                         ids=["int8_weights", "int8_weights_and_attention"])
def test_quantized_encoder_matches_jax(served, encoders, quantize_attention,
                                       mask_padding):
    """Encoder(quantize=True[, quantize_attention=True]) in both packages
    from one checkpoint: each quantizes the same fp32 weights itself (the
    same integers, tests/test_torch_quant.py). A last-bit difference in an
    fp32 pass can flip the rounding of an activation or of a p8 by one step
    of 1/127, so embeddings of |e| ~ 1 are held to 2e-2 absolute and a row
    cosine of 0.9999; vs the unquantized encoder the JAX tests' bar,
    cosine > 0.99."""
    ckpt, tok = served
    kw = dict(quantize=True, quantize_attention=quantize_attention)
    params, cfg = obt.training.checkpoint.load_model_checkpoint(ckpt)
    jenc = JaxEncoder(params, cfg, JaxSP(tok), **kw)
    model, _ = load_model_checkpoint(ckpt, device="cpu")
    penc = port_api.Encoder(model, SentencePieceProcessor(tok), device="cpu", **kw)
    assert penc.cfg.qkv_prepermuted and penc.cfg.attn_int8 == quantize_attention
    assert penc.model.cfg.attn_int8 == quantize_attention
    assert not model.cfg.qkv_prepermuted            # the caller's model is kept
    ekw = dict(method="mean", batch_size=2, mask_padding=mask_padding)
    want = jenc.encode_sequences(SEQS, **ekw)
    got = penc.encode_sequences(SEQS, **ekw)
    assert got.shape == want.shape == (len(SEQS), 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    assert _row_cosine(got, want).min() > 0.9999
    ref = encoders[1].encode_sequences(SEQS, **ekw)
    assert _row_cosine(got, ref).min() > 0.99
    assert np.abs(got - ref).max() > 0


def test_quantize_attention_needs_quantize(served):
    ckpt, tok = served
    model, _ = load_model_checkpoint(ckpt, device="cpu")
    with pytest.raises(ValueError, match="requires quantize=True"):
        port_api.Encoder(model, SentencePieceProcessor(tok),
                         quantize_attention=True, device="cpu")


def test_from_checkpoint_quantize_leaves_attention_in_bf16(served):
    """from_checkpoint(quantize=True), what the CLI's --quantize gives: int8
    weights, attn_int8 off, as in the JAX package."""
    ckpt, tok = served
    penc = port_api.Encoder.from_checkpoint(ckpt, tokenizer_path=tok,
                                            quantize=True, device="cpu")
    jenc = JaxEncoder.from_checkpoint(ckpt, tokenizer_path=tok, quantize=True)
    assert penc.cfg.qkv_prepermuted and not penc.cfg.attn_int8
    assert jenc.cfg.qkv_prepermuted and not jenc.cfg.attn_int8
    from omnibiote_tpu_torch.ops.quant import QuantizedLinear
    assert isinstance(penc.model.lm_head, QuantizedLinear)
    assert isinstance(penc.model.transformer.h[0].mlp.c_fc, QuantizedLinear)
    assert penc.model.transformer.h[1].attn.c_attn.values.dtype == torch.int8


def test_fasta_cli_quantize_matches_jax(served, tmp_path):
    ckpt, tok = served
    fasta = tmp_path / "in.fa"
    fasta.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(SEQS)))
    outs = {}
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_api.main, ["--device", "cpu"]),
                              ("port_fp", port_api.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.npz")
        flags = [] if name == "port_fp" else ["--quantize"]
        assert main(["--checkpoint", ckpt, "--fasta", str(fasta), "--out", out,
                     "--tokenizer-path", tok, "--batch-size", "2", *flags,
                     *extra]) == 0
        outs[name] = np.load(out)
    np.testing.assert_array_equal(outs["port"]["ids"], outs["jax"]["ids"])
    # the same bar as test_quantized_encoder_matches_jax
    np.testing.assert_allclose(outs["port"]["embeddings"],
                               outs["jax"]["embeddings"], rtol=0, atol=2e-2)
    assert _row_cosine(outs["port"]["embeddings"],
                       outs["port_fp"]["embeddings"]).min() > 0.99
    assert np.abs(outs["port"]["embeddings"] - outs["port_fp"]["embeddings"]).max() > 0


# ---------------------------------------------------------------------------
# Isolation and device
# ---------------------------------------------------------------------------

def _port_sources():
    pkg = os.path.join(REPO, "omnibiote_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    tools = sorted(f for f in os.listdir(os.path.join(REPO, "tools"))
                   if f.startswith("gpu_") and f.endswith(".py"))
    assert len(tools) >= 2
    for f in tools:
        yield os.path.join(REPO, "tools", f)


def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    sources = list(_port_sources())
    assert len(sources) > 25
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                if top in ("jax", "jaxlib", "flax", "optax", "omnibiote_tpu"):
                    bad.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not bad, bad


def test_port_imports_no_package_the_card_lacks():
    """The card's Python has numpy, scipy, einops, pytest and hypothesis
    beside torch and triton: no port module imports scikit-learn or pandas
    (the eval harness carries its own metrics and CSV reading)."""
    bad = []
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{os.path.relpath(path, REPO)}: {n}" for n in names
                    if n.split(".")[0] in ("sklearn", "pandas")]
    assert not bad, bad


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ckpt, tok = served
    cfg = port.OmniBioTAConfig(n_layer=1, n_head=1, n_embd=128, vocab_size=64,
                               block_size=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.OmniBioTA(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_api.Encoder.from_checkpoint(ckpt, tokenizer_path=tok)
    model = port.OmniBioTA(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_api.Encoder(model, SentencePieceProcessor(tok))


def test_cpu_tensor_never_touches_the_kernel(monkeypatch):
    """On a CPU tensor the wrappers (forward, backward, and the autograd
    Function through a training step's forward and backward, with
    dropout) run the plain versions and never build, load or count a
    kernel; the kernels' own entries refuse a CPU tensor instead of
    falling back."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was touched")

    monkeypatch.setattr(_kernels, "load_library", refuse)
    monkeypatch.setattr(_kernels, "build_all", refuse)
    before = dict(_kernels.LAUNCHES)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(x) for x in
               rng.standard_normal((3, 1, 128, 1, 128)).astype(np.float32))
    o, lse = port_flash.mh_flash_forward(q, k, v, None, None, scale=0.1)
    assert o.shape == q.shape and lse.shape == (1, 128, 1)
    assert _kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_flash.mh_flash_forward_kernel(q, k, v, None, None, scale=0.1)
    di = (o * q).sum(-1)
    dq, dk, dv = port_flash.mh_flash_backward(q, k, v, q, lse, di, scale=0.1,
                                              dropout_rate=0.1, seed=3)
    assert dq.shape == q.shape
    with pytest.raises(ValueError, match="not a CUDA tensor"):
        port_flash.mh_flash_backward_kernel(q, k, v, q, lse, di, scale=0.1)
    qg = q.clone().requires_grad_()
    port_flash.flash_attention(qg, k, v, scale=0.1, dropout_rate=0.1,
                               seed=4).sum().backward()
    assert qg.grad is not None
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.training.train import Trainer

    def rows():
        while True:
            toks = np.full((4, 128), 9, np.int32)
            yield {"tokens": toks, "segments": np.zeros_like(toks)}

    cfg = port.OmniBioTAConfig(n_layer=1, n_head=1, n_embd=128, vocab_size=64,
                               block_size=128, dropout=0.1)
    tr = Trainer(cfg, TrainConfig(batch_size=4, mini_batch_size=2, ctx_len=128),
                 batch_iter=rows(), device="cpu")
    assert np.isfinite(float(tr.train_step_once()["loss"]))
    assert _kernels.LAUNCHES == before
