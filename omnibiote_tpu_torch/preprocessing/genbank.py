"""GenBank flat-file preprocessing.

    python -m omnibiote_tpu_torch.preprocessing.genbank raw/ processed/genbank/

The port's copy of `omnibiote_tpu/preprocessing/genbank.py`, the equivalent
of the reference's preprocessing/preprocess_genbank.py, which uses BioPython
SeqIO (not a dependency of this repo) to parse `.seq.gz` GenBank release
files and emit one tagged string per file:

    <molecule_type>SEQUENCE<EOS><molecule_type>SEQUENCE<EOS>...

(tagging at preprocess_genbank.py:33). This module parses the GenBank flat
file format directly: the LOCUS line carries the molecule type (the value
BioPython exposes as annotations['molecule_type']), the ORIGIN section
carries the sequence, records end with '//'.
"""
from __future__ import annotations

import gzip
import os
import re
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, Iterator, Optional, Tuple

# LOCUS line:  LOCUS  name  1234 bp  ss-DNA  circular  VRL 01-JAN-2000
# molecule type is the token following the bp/aa length unit; strandedness
# prefixes (ss-, ds-, ms-) may be attached or separate.
_LOCUS_RE = re.compile(
    r"^LOCUS\s+\S+\s+\d+\s+(bp|aa|rc)\s+(?:(ss-|ds-|ms-)\s*)?(\S+)?",
    re.IGNORECASE)

_SEQ_CLEAN_RE = re.compile(r"[\s0-9/]")


def parse_genbank_records(lines: Iterator[str]) -> Iterator[Tuple[str, str]]:
    """Yield (molecule_type, sequence) per record from GenBank flat text."""
    mol: Optional[str] = None
    in_origin = False
    seq_parts = []
    for line in lines:
        if line.startswith("LOCUS"):
            m = _LOCUS_RE.match(line)
            mol = None
            if m:
                strand, mtype = m.group(2), m.group(3)
                if mtype:
                    mol = (strand or "") + mtype
            in_origin = False
            seq_parts = []
        elif line.startswith("ORIGIN"):
            in_origin = True
        elif line.startswith("//"):
            if mol and seq_parts:
                yield mol, "".join(seq_parts).upper()
            mol = None
            in_origin = False
            seq_parts = []
        elif in_origin:
            seq_parts.append(_SEQ_CLEAN_RE.sub("", line))


def process_seq_gz(gz_file_path: str, save_dir: str) -> Dict[str, int]:
    """Process one `.seq.gz` file to a tagged `.txt.gz` shard; returns
    molecule-type counts (reference process_seq_gz, :12-47)."""
    counts: Dict[str, int] = {}
    parts = []
    with gzip.open(gz_file_path, "rt", encoding="utf-8", errors="replace") as f:
        for mol, seq in parse_genbank_records(f):
            parts.append(f"<{mol}>{seq}<EOS>")
            counts[mol] = counts.get(mol, 0) + 1
    out = os.path.join(
        save_dir,
        os.path.basename(gz_file_path).replace(".seq.gz", ".txt.gz"))
    # atomic publish: main() skips any existing output name, so a shard
    # truncated by a mid-write crash would otherwise be treated as complete
    # forever (r4 review)
    tmp = out + ".tmp"
    with gzip.open(tmp, "wb") as f:
        f.write("".join(parts).encode("utf-8"))
    os.replace(tmp, out)
    return counts


def main(base_dir: str, save_dir: str, workers: int = 8) -> Dict[str, int]:
    """Process every unprocessed .seq.gz under base_dir (reference main(),
    :63-91): skips files whose .txt.gz output already exists."""
    import glob

    os.makedirs(save_dir, exist_ok=True)
    gz_files = sorted(glob.glob(os.path.join(base_dir, "*.seq.gz")))
    done = set(os.path.basename(p) for p in
               glob.glob(os.path.join(save_dir, "*.txt.gz")))
    todo = [p for p in gz_files
            if os.path.basename(p).replace(".seq.gz", ".txt.gz") not in done]

    totals: Dict[str, int] = {}
    if workers <= 1:
        for p in todo:
            for k, v in process_seq_gz(p, save_dir).items():
                totals[k] = totals.get(k, 0) + v
        return totals
    with ProcessPoolExecutor(max_workers=workers) as ex:
        futs = {ex.submit(process_seq_gz, p, save_dir): p for p in todo}
        for fut in as_completed(futs):
            try:
                for k, v in fut.result().items():
                    totals[k] = totals.get(k, 0) + v
            except Exception as e:  # mirror reference's per-file tolerance
                print(f"Error processing {futs[fut]}: {e}")
    return totals


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="GenBank .seq.gz -> tagged .txt.gz")
    ap.add_argument("base_dir")
    ap.add_argument("save_dir")
    ap.add_argument("--workers", type=int, default=8)
    a = ap.parse_args()
    print("Total sequence counts:", main(a.base_dir, a.save_dir, a.workers))
