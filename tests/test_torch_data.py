"""PyTorch port vs the JAX package: the data pipeline (the port's own copy
of `data/loader.py`) yields the same rows and segment ids from the same
shards and seed, resumes mid-stream from the same reader states, and packs
lines natively as the JAX package does; the port's prefetcher hands out
what its iterator yields, in order, on the device it was asked for."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import os

import numpy as np
import pytest
import torch

from omnibiote_tpu import EOS_TOKEN
from omnibiote_tpu.data import loader as jax_loader

from omnibiote_tpu_torch.data import loader as port_loader
from omnibiote_tpu_torch.data.prefetch import DevicePrefetcher

CORPORA = ["genbank/train", "uniref100/train"]


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    for corpus in CORPORA:
        d = root / corpus
        os.makedirs(d)
        for f in range(3):
            toks = []
            for _ in range(150):
                seq = rng.integers(20, 500, size=int(rng.integers(5, 90)))
                seq[-1] = EOS_TOKEN
                toks.extend(seq.tolist())
            np.save(d / f"s{f}.npy", np.asarray(toks, np.int32))
    return str(root)


def _pipelines(root, jstates=None, pstates=None, **kw):
    common = dict(batch_size=8, ctx_len=128, seed=3, banned_tokens=[77], **kw)
    j = jax_loader.build_pipeline(root, CORPORA, [0.75, 0.25],
                                  reader_states=jstates, **common)
    p = port_loader.build_pipeline(root, CORPORA, [0.75, 0.25],
                                   reader_states=pstates, **common)
    return j, p


def _assert_same_batches(jit, pit, n):
    for _ in range(n):
        a, b = next(jit), next(pit)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["segments"], b["segments"])


@pytest.mark.parametrize("use_padding", [False, True])
def test_pipeline_matches_jax_and_resumes_mid_stream(shards, use_padding):
    (jit, jst), (pit, pst) = _pipelines(shards, use_padding=use_padding)
    _assert_same_batches(jit, pit, 12)
    assert [s.to_dict() for s in jst] == [s.to_dict() for s in pst]
    # resume both from the port's mid-stream position (through the
    # checkpoint's dict form) and compare with the uninterrupted streams
    saved = [s.to_dict() for s in pst]
    (jit2, _), (pit2, _) = _pipelines(
        shards, [jax_loader.ReaderState.from_dict(d) for d in saved],
        [port_loader.ReaderState.from_dict(d) for d in saved],
        use_padding=use_padding)
    for _ in range(8):
        a, b, c = next(jit), next(pit2), next(jit2)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(c["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["segments"], b["segments"])


def test_native_packer_matches_jax():
    rng = np.random.default_rng(1)
    lines = [rng.integers(4, 300, size=int(rng.integers(1, 70))).astype(np.int32)
             for _ in range(200)]
    for pad in (False, True):
        want = jax_loader.pack_lines_native(lines, 96, pad)
        got = port_loader.pack_lines_native(lines, 96, pad)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        assert got[2] == want[2]


def test_native_row_stream_matches_jax(shards):
    files = port_loader.list_shards(shards, CORPORA[:1])[0]
    j = jax_loader.native_row_stream(files, ctx_len=128, seed=5)
    p = port_loader.native_row_stream(files, ctx_len=128, seed=5)
    for _ in range(40):
        (jr, js), (pr, ps) = next(j), next(p)
        np.testing.assert_array_equal(jr, pr)
        np.testing.assert_array_equal(js, ps)
    assert j.state.to_dict() == p.state.to_dict()


def test_prefetcher_yields_items_in_order_on_the_cpu():
    items = [({"tokens": np.full((2, 3), i, np.int32)}, [1.0, float(i)])
             for i in range(7)]
    with DevicePrefetcher(iter(items), device="cpu", depth=2) as pf:
        got = list(pf)
    assert len(got) == 7
    for i, (batch, weights) in enumerate(got):
        assert isinstance(batch["tokens"], torch.Tensor)
        assert batch["tokens"].device.type == "cpu"
        assert torch.equal(batch["tokens"], torch.full((2, 3), i, dtype=torch.int32))
        assert weights == [1.0, float(i)]


def test_prefetcher_surfaces_errors_and_closes():
    def bad():
        yield {"x": np.zeros(2)}
        raise ValueError("broken shard")

    pf = DevicePrefetcher(bad(), device="cpu")
    next(pf)
    with pytest.raises(ValueError, match="broken shard"):
        next(pf)
    pf.close()

    def endless():
        while True:
            yield np.zeros(4)

    pf = DevicePrefetcher(endless(), device="cpu", depth=2)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DevicePrefetcher(iter([]))
