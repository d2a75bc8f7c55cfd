"""Test helper: build a tiny in-memory SentencePiece-format model file.

Port of `omnibiote_tpu/tokenizer/cpp_test_util.py`, over the port's own
`SentencePieceProcessor`. It writes a minimal ModelProto (the specials, the
user-defined pieces, then the given normal pieces, and an identity
normalizer) so BPE merges can be tested against hand-computable
expectations without the reference's tokenizer files. Given the same
pieces, the file is the JAX helper's byte for byte.
"""
from __future__ import annotations

import struct
import tempfile
from typing import List, Sequence, Tuple

from . import SentencePieceProcessor

# ModelProto.SentencePiece.Type
NORMAL, UNKNOWN, CONTROL, USER_DEFINED = 1, 2, 3, 4


def _varint(v: int) -> bytes:
    out = b""
    while v >= 0x80:
        out += bytes([v & 0x7F | 0x80])
        v >>= 7
    return out + bytes([v])


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _bytes_field(field: int, data: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(data)) + data


def _piece(piece: str, score: float, ptype: int = NORMAL) -> bytes:
    """One `pieces` entry: the piece, its fp32 score and, unless NORMAL
    (the proto's default), its type."""
    sub = _bytes_field(1, piece.encode())
    sub += _tag(2, 5) + struct.pack("<f", score)
    if ptype != NORMAL:
        sub += _tag(3, 0) + _varint(ptype)
    return _bytes_field(1, sub)


def model_bytes(normal_pieces: Sequence[Tuple[str, float]],
                user_defined: Sequence[str] = (),
                add_dummy_prefix: bool = True) -> bytes:
    """The serialized ModelProto: <unk>, <s>, </s>, the user-defined pieces,
    then (piece, score) of the normal pieces, in that order (their ids);
    the normalizer is the identity with the whitespace rules on."""
    blob = (_piece("<unk>", 0.0, UNKNOWN) + _piece("<s>", 0.0, CONTROL)
            + _piece("</s>", 0.0, CONTROL))
    for u in user_defined:
        blob += _piece(u, 0.0, USER_DEFINED)
    for p, s in normal_pieces:
        blob += _piece(p, s, NORMAL)
    # NormalizerSpec: identity (no charsmap), whitespace rules on
    norm = _bytes_field(1, b"identity")
    norm += _tag(3, 0) + _varint(1 if add_dummy_prefix else 0)
    norm += _tag(4, 0) + _varint(1)
    return blob + _bytes_field(3, norm)


def build_model(normal_pieces: List[Tuple[str, float]],
                user_defined: Sequence[str] = (),
                add_dummy_prefix: bool = True) -> SentencePieceProcessor:
    """A processor loaded from `model_bytes(...)`, written to a temporary
    .model file (left in place, as the JAX helper leaves it)."""
    with tempfile.NamedTemporaryFile(suffix=".model", delete=False) as f:
        f.write(model_bytes(normal_pieces, user_defined, add_dummy_prefix))
    return SentencePieceProcessor(f.name)
