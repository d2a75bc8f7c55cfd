"""BPE tokenizer training CLI (fills SURVEY.md gap C4's sibling: the
reference ships trained tokenizers/*.model artifacts but no trainer).

    python -m omnibiote_tpu_torch.tokenizer.train_cli 'corpus/*.txt.gz' out.model \
        --vocab_size 65536 --user_defined "<EOS>,<DNA>,<mRNA>,...,<protein>"

Reads tagged text shards (gzip or plain), trains the C++ BPE trainer, and
writes a .model file loadable by SentencePieceProcessor (and therefore by
the whole pipeline). The port's copy of `omnibiote_tpu/tokenizer/train_cli.py`,
on the port's own tokenizer build.
"""
from __future__ import annotations

import argparse
import glob
import gzip

from . import SentencePieceProcessor, train_bpe

DEFAULT_USER_DEFINED = (
    "<EOS>,<DNA>,<mRNA>,<RNA>,<rRNA>,<tRNA>,<cRNA>,<ss-RNA>,<ss-DNA>,"
    "<ds-mRNA>,<ds-rRNA>,<ds-RNA>,<ms-DNA>,<ms-RNA>,<ds-cRNA>,"
    "<protein>,<antibody>")


def iter_sentences(paths, max_sentences=None):
    n = 0
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", errors="replace") as f:
            text = f.read()
        for rec in text.split("<EOS>"):
            if rec.strip():
                yield rec + "<EOS>"
                n += 1
                if max_sentences and n >= max_sentences:
                    return


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train a BPE tokenizer")
    ap.add_argument("input_glob")
    ap.add_argument("out_path")
    ap.add_argument("--vocab_size", type=int, default=65536)
    ap.add_argument("--user_defined", default=DEFAULT_USER_DEFINED)
    ap.add_argument("--max_piece_len", type=int, default=16)
    ap.add_argument("--max_sentences", type=int, default=1_000_000,
                    help="sentence subsample cap (SentencePiece-style)")
    a = ap.parse_args(argv)

    sentences = list(iter_sentences(sorted(glob.glob(a.input_glob)),
                                    a.max_sentences))
    print(f"training on {len(sentences)} sentences...")
    train_bpe(sentences, a.vocab_size, a.out_path,
              user_defined=[u for u in a.user_defined.split(",") if u],
              max_piece_len=a.max_piece_len)
    sp = SentencePieceProcessor(a.out_path)
    print(f"wrote {a.out_path}: vocab_size={sp.vocab_size()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
