"""High-level serving API: strings in, embeddings out, on the GPU.

    from omnibiote_tpu_torch.api import Encoder

    enc = Encoder.from_checkpoint("checkpoints/omnibiota", tokenizer="mixed")
    embs = enc.encode_sequences(["<DNA>ACGT...", "<protein>MKV..."],
                                method="mean")

Reads the checkpoints the JAX package writes (params.npz + meta.json) and
computes the same embeddings; attention runs through the hand-written CUDA
kernel (ops/csrc/mh_flash_fwd.cu), or with quantize_attention=True through
the int8 one (ops/csrc/int8_flash_fwd.cu).

Data-parallel serving: `Encoder(..., mesh=make_mesh())` on every rank of a
torchrun group (or `--data-parallel`): each data rank encodes its rows of
every batch (a short final batch padded with copies of its first row up to
the rank count) and the pooled rows are all-gathered back in order, so
every rank returns the single-device embeddings.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .config import BANNED_TOKEN
from .evals.common import pad_batch, tokenize_sequences
from .models.omnibiota import OmniBioTA, encode
from .utils.device import resolve_device

METHODS = ("mean", "first", "last", "max")


class Encoder:
    """Model + tokenizer, batched string encoding."""

    def __init__(self, model: OmniBioTA, sp, banned_tokens: Sequence[int] = (),
                 quantize: bool = False, quantize_attention: bool = False,
                 mesh=None, device=None):
        """model: an OmniBioTA (moved to `device`; None: the GPU).

        quantize=True serves from a copy of the model in the int8 format
        (ops/quant.py): int8 weights, activations quantized per row on the
        fly, int32 accumulation.

        quantize_attention=True additionally runs attention itself in int8
        (ops/int8_attention.py); it needs quantize=True. Off by default, as
        in the JAX package, and `from_checkpoint` and the CLI leave it off.

        mesh: a DeviceMesh (parallel.mesh.make_mesh) whose 'data' axis
        splits each batch's rows; the model is replicated and runs on the
        mesh's device."""
        if quantize_attention and not quantize:
            raise ValueError(
                "quantize_attention=True requires quantize=True (int8 "
                "attention goes with the quantized weight format)")
        self.mesh = mesh
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            from .parallel.mesh import (DATA_AXIS, axis_group, axis_index,
                                        axis_size, mesh_device)
            if not isinstance(mesh, DeviceMesh):
                raise TypeError("mesh must be a torch.distributed DeviceMesh "
                                "(omnibiote_tpu_torch.parallel.mesh.make_mesh)")
            self.n_data = axis_size(mesh, DATA_AXIS)
            self.data_index = axis_index(mesh, DATA_AXIS)
            self._data_group = axis_group(mesh, DATA_AXIS)
            device = mesh_device(mesh)
        self.device = resolve_device(device)
        model = model.to(self.device).eval()
        if quantize:
            from .ops.quant import quantize_for_inference
            model = quantize_for_inference(model)
            model.cfg = model.cfg.replace(attn_int8=quantize_attention)
        self.model = model
        self.cfg = model.cfg.replace(dropout=0.0)
        self.sp = sp
        self.banned = list(banned_tokens)

    @classmethod
    def from_checkpoint(cls, path: str, tokenizer: str = "mixed",
                        tokenizer_path: Optional[str] = None,
                        quantize: bool = False, mesh=None, device=None):
        from .tokenizer import SentencePieceProcessor, load_reference
        from .training.checkpoint import load_model_checkpoint

        model, _ = load_model_checkpoint(path, device=device)
        sp = (SentencePieceProcessor(tokenizer_path) if tokenizer_path
              else load_reference(tokenizer))
        # the banned-id table describes the reference tokenizers only: in a
        # custom vocab that id may be a legitimate piece
        banned = ([BANNED_TOKEN[tokenizer]]
                  if tokenizer_path is None and tokenizer in BANNED_TOKEN
                  else [])
        return cls(model, sp, banned, quantize=quantize, mesh=mesh,
                   device=device)

    @torch.inference_mode()
    def _pool(self, tokens, segments, lengths, method: str):
        """Padding-aware pooling in the compute dtype: PAD positions are
        masked out of attention (segments) and out of mean/max."""
        emb = self.model(tokens, segments, return_embeddings=True)
        T = tokens.shape[1]
        valid = (torch.arange(T, device=tokens.device)[None, :]
                 < lengths[:, None])[..., None]
        if method == "mean":
            return (emb * valid).sum(dim=1) / lengths[:, None].clamp(min=1)
        if method == "first":
            return emb[:, 0]
        if method == "last":
            idx = (lengths - 1).clamp(min=0)
            return emb[torch.arange(emb.shape[0], device=emb.device), idx]
        neg = torch.full((), -float("inf"), dtype=emb.dtype, device=emb.device)
        return torch.where(valid, emb, neg).amax(dim=1)

    def encode_sequences(self, sequences: List[str], method: str = "mean",
                         batch_size: int = 32, bucket: int = 128,
                         mask_padding: bool = True) -> np.ndarray:
        """Tokenize, pad, and pool; (N, n_embd) float32. mask_padding=True
        keeps PAD positions out of attention and pooling; False is the
        reference's bare encode(), where padding leaks into the statistics."""
        if method not in METHODS:
            raise ValueError(
                f"unknown pooling {method!r}: encode_sequences supports "
                "mean/first/last/max (for per-position embeddings call "
                "encode(model, tokens, 'all') directly)")
        toks = tokenize_sequences(self.sp, sequences, banned_tokens=self.banned)
        outs = []
        for i in range(0, len(toks), batch_size):
            chunk = toks[i:i + batch_size]
            x, seg = pad_batch(chunk, bucket, self.cfg.block_size)
            lengths = np.asarray([min(len(t), x.shape[1]) for t in chunk],
                                 np.int32)
            n_rows = len(chunk)
            if self.mesh is not None:
                # this rank's rows; the final short chunk padded by repeating
                # row 0 (trimmed below) so every rank gets as many
                pad = -n_rows % self.n_data
                x, seg, lengths = (np.concatenate([a, np.repeat(a[:1], pad, 0)])
                                   for a in (x, seg, lengths))
                per = len(x) // self.n_data
                lo = self.data_index * per
                x, seg, lengths = x[lo:lo + per], seg[lo:lo + per], lengths[lo:lo + per]
            x = torch.from_numpy(x).to(self.device)
            if mask_padding:
                out = self._pool(x, torch.from_numpy(seg).to(self.device),
                                 torch.from_numpy(lengths).to(self.device),
                                 method)
            else:
                out = encode(self.model, x, method)
            out = out.float()
            if self.mesh is not None:
                parts = [torch.empty_like(out) for _ in range(self.n_data)]
                torch.distributed.all_gather(parts, out.contiguous(),
                                             group=self._data_group)
                out = torch.cat(parts)[:n_rows]
            outs.append(out.cpu().numpy())
        return (np.concatenate(outs) if outs
                else np.zeros((0, self.cfg.n_embd), np.float32))


def iter_fasta(path):
    """Yield (record_id, sequence) from a FASTA file (.gz transparent): the
    id is the first whitespace-delimited token after '>', sequence lines
    are concatenated verbatim (the tokenizers are case-sensitive)."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    rid, parts = None, []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if rid is not None:
                    yield rid, "".join(parts)
                header = line[1:].strip()
                rid = header.split()[0] if header else ""
                parts = []
            elif line and rid is not None:
                parts.append(line)
    if rid is not None:
        yield rid, "".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """FASTA -> pooled-embeddings CLI.

        python -m omnibiote_tpu_torch.api \\
            --checkpoint checkpoints/omnibiota --fasta seqs.fa.gz \\
            --tag protein --out embeddings.npz

    Writes an .npz with `ids` (N,) and `embeddings` (N, n_embd) float32,
    row-aligned with the FASTA record order."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m omnibiote_tpu_torch.api",
        description="Encode FASTA sequences to pooled embeddings (.npz).")
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint directory (meta.json + npz)")
    ap.add_argument("--fasta", required=True, help="input FASTA (.gz ok)")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--method", default="mean", choices=list(METHODS))
    ap.add_argument("--tag", default="none",
                    choices=["protein", "dna", "none"],
                    help="modality tag prepended to every sequence "
                         "(<protein>/<DNA>), matching pretraining corpus "
                         "tagging")
    ap.add_argument("--tokenizer", default="mixed",
                    help="reference tokenizer name (mixed/peptide/"
                         "nucleotide) when --tokenizer-path is not given")
    ap.add_argument("--tokenizer-path", default=None,
                    help="explicit .model file (e.g. a CLI-trained vocab)")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--bucket", type=int, default=128,
                    help="pad lengths up to a multiple of this")
    ap.add_argument("--chunk", type=int, default=4096,
                    help="sequences held in memory per encode call")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 serving weights (ops/quant.py)")
    ap.add_argument("--data-parallel", action="store_true",
                    help="under torchrun: split each batch's rows over the "
                         "ranks (a 'data' mesh axis); results identical to "
                         "one device; rank 0 writes --out")
    ap.add_argument("--leaky-padding", action="store_true",
                    help="bit-faithful reference pooling: padding leaks "
                         "into mean/max statistics")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' for a host "
                         "without a GPU)")
    args = ap.parse_args(argv)

    mesh = None
    if args.data_parallel:
        from .parallel.mesh import make_mesh
        mesh = make_mesh(device=args.device)
    enc = Encoder.from_checkpoint(args.checkpoint, tokenizer=args.tokenizer,
                                  tokenizer_path=args.tokenizer_path,
                                  quantize=args.quantize, mesh=mesh,
                                  device=args.device)
    prefix = {"protein": "<protein>", "dna": "<DNA>", "none": ""}[args.tag]

    ids: List[str] = []
    chunks: List[np.ndarray] = []
    buf: List[str] = []

    def flush():
        if buf:
            chunks.append(enc.encode_sequences(
                buf, method=args.method, batch_size=args.batch_size,
                bucket=args.bucket, mask_padding=not args.leaky_padding))
            buf.clear()

    for rid, seq in iter_fasta(args.fasta):
        ids.append(rid)
        buf.append(prefix + seq)
        if len(buf) >= args.chunk:
            flush()
    flush()

    emb = (np.concatenate(chunks) if chunks
           else np.zeros((0, enc.cfg.n_embd), np.float32))
    if mesh is not None and torch.distributed.get_rank() != 0:
        return 0
    np.savez(args.out, ids=np.asarray(ids), embeddings=emb)
    print(f"wrote {emb.shape[0]} embeddings (dim {emb.shape[1]}) "
          f"to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
