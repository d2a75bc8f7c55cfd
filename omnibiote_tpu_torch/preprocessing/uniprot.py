"""UniRef100 FASTA -> tagged text shards.

    python -m omnibiote_tpu_torch.preprocessing.uniprot uniref100.fasta.gz processed/uniref100/

The port's copy of `omnibiote_tpu/preprocessing/uniprot.py`, the behavioural
equivalent of the reference's preprocessing/preprocess_uniprot.py: stream
uniref100.fasta.gz without ever holding it in memory, strip FASTA
headers, and emit numbered .txt.gz shards of `<protein>SEQ<EOS>...` text
(the tagging convention the tokenizer corpus expects,
preprocess_uniprot.py:59-60).

Re-designed as an incremental record parser (iter_sequences) feeding a
size-budgeted shard writer, instead of the reference's chunk/residual
hand-off. One deliberate behaviour difference: the reference's final
process_chunk('', residual) call can never emit the trailing record —
str.split('>') keeps the whole residual as the next residual
(preprocess_uniprot.py:69) — so the corpus's last sequence is silently
dropped there; iter_sequences flushes it at end of stream.
"""
from __future__ import annotations

import gzip
import os
from typing import Iterable, Iterator, List

CHUNK_SIZE = 128 * 1024 ** 2


def _record_sequence(record: str) -> str:
    """One '>'-delimited FASTA record -> its sequence (header line and
    newlines removed)."""
    parts = record.split("\n", 1)
    return parts[1].replace("\n", "") if len(parts) > 1 else ""


def iter_sequences(text_chunks: Iterable[str]) -> Iterator[str]:
    """Incremental FASTA parser: consume arbitrarily-sized text chunks,
    yield each record's sequence. Robust to records spanning chunk
    boundaries; the final (unterminated) record is flushed at end of
    stream."""
    pending = ""
    for chunk in text_chunks:
        pending += chunk
        records = pending.split(">")
        pending = records.pop()  # may be an incomplete record: keep buffering
        for rec in records:
            seq = _record_sequence(rec)
            if seq:
                yield seq
    seq = _record_sequence(pending)
    if seq:
        yield seq


def tagged_shard(sequences: List[str]) -> str:
    """Corpus text for one shard: every sequence tagged and EOS-terminated."""
    return "".join(f"<protein>{s}<EOS>" for s in sequences)


def _gz_chunks(path: str, chunk_size: int) -> Iterator[str]:
    with gzip.open(path, "rt") as f:
        while True:
            chunk = f.read(chunk_size)
            if not chunk:
                return
            yield chunk


def main(fasta_path: str, out_dir: str, chunk_size: int = CHUNK_SIZE) -> int:
    """Shard the whole FASTA; returns the number of shards written. Shards
    close when their accumulated sequence text reaches chunk_size, keeping
    peak memory bounded by one shard."""
    os.makedirs(out_dir, exist_ok=True)

    def write_shard(idx: int, seqs: List[str]):
        path = os.path.join(out_dir, f"uniref100_{idx}.txt.gz")
        with gzip.open(path, "wt") as f:
            f.write(tagged_shard(seqs))

    shard: List[str] = []
    shard_chars = 0
    n_shards = 0
    for seq in iter_sequences(_gz_chunks(fasta_path, chunk_size)):
        shard.append(seq)
        shard_chars += len(seq)
        if shard_chars >= chunk_size:
            write_shard(n_shards, shard)
            n_shards += 1
            shard, shard_chars = [], 0
    if shard:
        write_shard(n_shards, shard)
        n_shards += 1
    return n_shards


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="UniRef100 fasta.gz -> tagged shards")
    ap.add_argument("fasta_path")
    ap.add_argument("out_dir")
    ap.add_argument("--chunk_size", type=int, default=CHUNK_SIZE)
    a = ap.parse_args()
    main(a.fasta_path, a.out_dir, a.chunk_size)
