"""Tagged-text -> token-shard conversion (fills SURVEY.md gap C4).

    python -m omnibiote_tpu_torch.preprocessing.tokenize_corpus \
        'processed/genbank/*.txt.gz' data/genbank --tokenizer mixed_bpe.model

The port's copy of `omnibiote_tpu/preprocessing/tokenize_corpus.py`, on the
port's own tokenizer build. Its train/ and val/ directories are what the
loader reads (`--train_type mixed`: genbank/ and uniref100/ under
--base_dir).

The reference loader consumes `.npy` int-token shards with inline EOS
separators (loader.py:40-44) but no script in the reference produces them
from the `.txt.gz` output of the preprocessors. This is that missing step:

  .txt.gz ("<DNA>ACGT<EOS><mRNA>AUGC<EOS>...")
      -> batch C++ BPE encode (records split on <EOS>)
      -> concatenated int32 token stream (EOS id 3 inline)
      -> fixed-size .npy shards in train/ and val/ splits

Token-id conventions match the loader: EOS=3; the spurious '▁' piece is NOT
filtered here — the reader filters banned tokens at load time, like the
reference (loader.py:53-58).
"""
from __future__ import annotations

import gzip
import os
from typing import Iterator, List, Sequence

import numpy as np

from ..config import EOS_TOKEN
from ..tokenizer import SentencePieceProcessor

_EOS_ARR = np.asarray([EOS_TOKEN], np.int32)

DEFAULT_SHARD_TOKENS = 25_000_000  # ~100 MB of int32 per shard (loader.py:33)


def iter_records(txt_gz_paths: Sequence[str]) -> Iterator[str]:
    """Yield one tagged record at a time: '<TAG>SEQ' (EOS delimiter removed,
    re-added as a token id)."""
    for path in txt_gz_paths:
        with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
            text = f.read()
        for rec in text.split("<EOS>"):
            if rec:
                yield rec


def tokenize_to_shards(
    txt_gz_paths: Sequence[str],
    out_dir: str,
    sp: SentencePieceProcessor,
    *,
    shard_tokens: int = DEFAULT_SHARD_TOKENS,
    val_fraction: float = 0.01,
    batch_records: int = 2048,
    n_threads: int = 8,
    seed: int = 0,
    prefix: str = "shard",
) -> dict:
    """Tokenize records into train/val .npy shards; returns statistics."""
    train_dir = os.path.join(out_dir, "train")
    val_dir = os.path.join(out_dir, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)

    rng = np.random.default_rng(seed)
    buffers = {"train": [], "val": []}
    counts = {"train": 0, "val": 0}
    shard_idx = {"train": 0, "val": 0}
    n_records = 0

    def flush(split: str, force: bool = False):
        total = sum(len(b) for b in buffers[split])
        if total == 0 or (total < shard_tokens and not force):
            return
        arr = np.concatenate(buffers[split]).astype(np.int32)
        d = train_dir if split == "train" else val_dir
        np.save(os.path.join(d, f"{prefix}_{shard_idx[split]:05d}.npy"), arr)
        shard_idx[split] += 1
        counts[split] += len(arr)
        buffers[split].clear()

    batch: List[str] = []

    def process_batch():
        nonlocal n_records
        if not batch:
            return
        encoded = sp.encode_batch(batch, n_threads=n_threads)
        for ids in encoded:
            split = "val" if rng.random() < val_fraction else "train"
            # int32 concatenate, NOT np.append (whose default-int64 scalar
            # promotes the whole buffered record to int64, doubling the
            # shard buffer's memory until flush)
            buffers[split].append(np.concatenate(
                [np.asarray(ids, np.int32), _EOS_ARR]))
            n_records += 1
        batch.clear()
        flush("train")
        flush("val")

    for rec in iter_records(txt_gz_paths):
        batch.append(rec)
        if len(batch) >= batch_records:
            process_batch()
    process_batch()
    flush("train", force=True)
    flush("val", force=True)
    return {
        "records": n_records,
        "train_tokens": counts["train"],
        "val_tokens": counts["val"],
        "train_shards": shard_idx["train"],
        "val_shards": shard_idx["val"],
    }


if __name__ == "__main__":
    import argparse
    import glob

    ap = argparse.ArgumentParser(
        description="tagged .txt.gz -> tokenized .npy shards")
    ap.add_argument("input_glob", help="e.g. 'processed/*.txt.gz'")
    ap.add_argument("out_dir")
    ap.add_argument("--tokenizer", required=True,
                    help="path to a .model file (e.g. the reference mixed_bpe)")
    ap.add_argument("--shard_tokens", type=int, default=DEFAULT_SHARD_TOKENS)
    ap.add_argument("--val_fraction", type=float, default=0.01)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()

    proc = SentencePieceProcessor(a.tokenizer)
    stats = tokenize_to_shards(
        sorted(glob.glob(a.input_glob)), a.out_dir, proc,
        shard_tokens=a.shard_tokens, val_fraction=a.val_fraction,
        n_threads=a.threads, seed=a.seed)
    print(stats)
