"""SentencePiece-compatible tokenizer: C++ core + ctypes binding.

Drop-in for the `sentencepiece` Python API surface the reference uses
(encode / decode / id_to_piece / piece-length queries; e.g. the
reference's evals/gue.py:275-276, proteinGLUE.py:218). The core is a
from-scratch C++ implementation (cpp/spm.cc) that loads the reference's
binary `.model` protos (its tokenizers/ directory).

The port's own copy of the JAX package's tokenizer: same sources, its own
build (compiled on first use with g++ into cpp/build/libobtspm.so beside
these sources, or a user cache under `omnibiote_tpu_torch`), so the two
packages never share a library.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Iterable, List, Optional, Sequence

import numpy as np

_CPP_DIR = os.path.join(os.path.dirname(__file__), "cpp")
_SO_PATH = os.path.join(_CPP_DIR, "build", "libobtspm.so")

# The reference repository's tokenizers/ directory.
REFERENCE_TOKENIZER_DIR = os.environ.get(
    "OBT_REFERENCE_TOKENIZER_DIR",
    os.path.join(os.path.expanduser("~"), "reference", "tokenizers"))


def _so_candidates():
    """Build locations in preference order: next to the sources (fast,
    shared across users of one checkout), then a user-writable cache —
    a system-wide `pip install .` puts the package under a root-owned
    site-packages where the first candidate is not writable."""
    yield _SO_PATH
    cache = os.path.join(
        os.environ.get("OBT_TOKENIZER_BUILD_DIR")
        or os.path.join(os.path.expanduser("~"), ".cache"),
        "omnibiote_tpu_torch", "tokenizer")
    yield os.path.join(cache, "libobtspm.so")
    import tempfile
    yield os.path.join(tempfile.gettempdir(),
                       f"omnibiote_tpu_torch-{os.getuid()}", "libobtspm.so")


def _build_library() -> str:
    srcs = [os.path.join(_CPP_DIR, "spm.cc"), os.path.join(_CPP_DIR, "capi.cc"),
            os.path.join(_CPP_DIR, "packer.cc")]
    newest_src = max(os.path.getmtime(s) for s in srcs)
    errors = []
    for so_path in _so_candidates():
        if os.path.exists(so_path) and os.path.getmtime(so_path) > newest_src:
            return so_path
        try:
            os.makedirs(os.path.dirname(so_path), exist_ok=True)
            # compile to a per-process temp name and publish atomically:
            # concurrent importers (multiprocess loaders, multi-host startup
            # on a shared FS) must never CDLL a half-written .so
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = [
                "g++", "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
                "-o", tmp, *srcs,
            ]
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so_path)
            return so_path
        except (OSError, subprocess.CalledProcessError) as e:
            # read-only/root-owned package dir: fall through to the next
            # user-writable candidate; a compiler error repeats identically
            # everywhere, so surface the first one if all candidates fail
            errors.append((so_path, e))
    raise RuntimeError(
        "could not build the tokenizer C++ core in any candidate dir: "
        + "; ".join(f"{p}: {e}" for p, e in errors))


_lib = None


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build_library())
        lib.obt_spm_load.restype = ctypes.c_void_p
        lib.obt_spm_load.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.obt_spm_free.argtypes = [ctypes.c_void_p]
        lib.obt_spm_vocab_size.argtypes = [ctypes.c_void_p]
        lib.obt_spm_unk_id.argtypes = [ctypes.c_void_p]
        lib.obt_spm_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.obt_spm_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.obt_spm_decode.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_int]
        lib.obt_spm_id_to_piece.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.obt_spm_piece_to_id.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.obt_spm_score.restype = ctypes.c_float
        lib.obt_spm_score.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.obt_spm_piece_type.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.obt_spm_train.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p]
        lib.obt_spm_train_ex.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.obt_pack_lines.restype = ctypes.c_long
        lib.obt_pack_lines.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_long),
            ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
        lib.obt_pack_chunk.restype = ctypes.c_long
        lib.obt_pack_chunk.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_long]
        _lib = lib
    return _lib


class SentencePieceProcessor:
    """API-compatible subset of sentencepiece.SentencePieceProcessor."""

    def __init__(self, model_file: Optional[str] = None):
        self._h = None
        if model_file is not None:
            self.load(model_file)

    def load(self, model_file: str):
        lib = _load_lib()
        err = ctypes.create_string_buffer(256)
        h = lib.obt_spm_load(model_file.encode(), err, 256)
        if not h:
            raise ValueError(f"failed to load {model_file}: "
                             f"{err.value.decode()}")
        if getattr(self, "_h", None):  # re-load: free the previous native
            self._lib.obt_spm_free(self._h)  # model, don't leak it
        self._h = ctypes.c_void_p(h)
        self._lib = lib
        return self

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.obt_spm_free(self._h)
            self._h = None

    # -- sentencepiece-compatible surface ---------------------------------

    def vocab_size(self) -> int:
        return self._lib.obt_spm_vocab_size(self._h)

    get_piece_size = vocab_size
    piece_size = vocab_size

    def unk_id(self) -> int:
        return self._lib.obt_spm_unk_id(self._h)

    def encode(self, text, out_type=int):
        if isinstance(text, (list, tuple)):
            return [self.encode(t, out_type) for t in text]
        data = text.encode("utf-8")
        cap = max(64, len(data) * 2)
        buf = (ctypes.c_int * cap)()
        n = self._lib.obt_spm_encode(self._h, data, len(data), buf, cap)
        if n > cap:
            buf = (ctypes.c_int * n)()
            self._lib.obt_spm_encode(self._h, data, len(data), buf, n)
        ids = list(buf[:n])
        if out_type is int:
            return ids
        return [self.id_to_piece(i) for i in ids]

    encode_as_ids = encode
    EncodeAsIds = encode

    def encode_batch(self, texts: Sequence[str], n_threads: int = 8,
                     cap_factor: int = 2) -> List[np.ndarray]:
        """Parallel batch encode (C++ thread pool)."""
        blobs = [t.encode("utf-8") for t in texts]
        flat = b"".join(blobs)
        offsets = np.zeros(len(blobs) + 1, np.int64)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        cap = max(64, max((len(b) for b in blobs), default=0) * cap_factor)
        out = np.zeros((len(blobs), cap), np.int32)
        lens = np.zeros(len(blobs), np.int32)
        self._lib.obt_spm_encode_batch(
            self._h, flat, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(blobs), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), n_threads)
        # nmt_nfkc normalization can EXPAND text past cap (e.g. U+FDFA ->
        # ~33 chars): the C side reports the true length, so re-encode the
        # rare oversized items through encode()'s retrying path instead of
        # silently truncating the corpus stream
        return [np.asarray(self.encode(texts[i]), np.int32)
                if lens[i] > cap else out[i, :lens[i]].copy()
                for i in range(len(blobs))]

    def decode(self, ids) -> str:
        if isinstance(ids, np.ndarray) and ids.ndim == 1:
            ids = ids.tolist()
        # len()-based check: `if ids` on an ndarray raises the ambiguous-
        # truth-value error, and encode_batch (this module) returns
        # ndarrays
        if len(ids) and isinstance(ids[0], (list, tuple, np.ndarray)):
            return [self.decode(list(x)) for x in ids]
        arr = (ctypes.c_int * len(ids))(*[int(i) for i in ids])
        cap = max(64, len(ids) * 8)
        buf = ctypes.create_string_buffer(cap)
        n = self._lib.obt_spm_decode(self._h, arr, len(ids), buf, cap)
        if n > cap:
            # retry with the true length — and slice with IT, not the old
            # cap (the old slice silently truncated long decodes)
            cap = n
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.obt_spm_decode(self._h, arr, len(ids), buf, cap)
        return buf.raw[:n].decode("utf-8", errors="replace")

    decode_ids = decode
    DecodeIds = decode

    def id_to_piece(self, id: int) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.obt_spm_id_to_piece(self._h, int(id), buf, 256)
        if n < 0:
            raise IndexError(f"piece id {id} out of range")
        return buf.raw[:n].decode("utf-8", errors="replace")

    IdToPiece = id_to_piece

    def piece_to_id(self, piece: str) -> int:
        return self._lib.obt_spm_piece_to_id(self._h, piece.encode("utf-8"))

    PieceToId = piece_to_id

    def get_score(self, id: int) -> float:
        return float(self._lib.obt_spm_score(self._h, int(id)))

    def piece_type(self, id: int) -> int:
        return int(self._lib.obt_spm_piece_type(self._h, int(id)))

    def is_control(self, id: int) -> bool:
        return self.piece_type(id) == 3

    def is_unknown(self, id: int) -> bool:
        return self.piece_type(id) == 2


def train_bpe(sentences: Iterable[str], vocab_size: int, out_path: str,
              user_defined: Sequence[str] = (), control: Sequence[str] = (),
              max_piece_len: int = 16, naive: bool = False) -> str:
    """Train a BPE model and write a loadable .model file.

    Fills the reference's missing tokenizer-training step (SURVEY.md C4):
    no script in the reference produces its tokenizers/*.model artifacts.

    The default trainer is the linked-list + lazy-heap fast path
    (O((corpus + merges) log) — full-corpus vocab training); naive=True
    selects the O(merges * corpus) reference-shaped loop it is
    parity-tested against (byte-identical .model output).
    """
    lib = _load_lib()
    sentences = list(sentences)
    # the C boundary marshals sentences newline-separated and symbols
    # comma-separated: an embedded separator would silently change the
    # training corpus / symbol list, so reject it here
    if any("\n" in s for s in sentences):
        raise ValueError("training sentences must not contain newlines "
                         "(the C trainer treats '\\n' as the sentence "
                         "separator); split or strip them first")
    if any("," in s for s in (*user_defined, *control)):
        raise ValueError("user_defined/control symbols must not contain "
                         "',' (the C trainer's symbol-list separator)")
    blob = "\n".join(sentences).encode("utf-8")
    rc = lib.obt_spm_train_ex(
        blob, len(blob), vocab_size, ",".join(user_defined).encode(),
        ",".join(control).encode(), max_piece_len, out_path.encode(),
        1 if naive else 0)
    if rc != 0:
        raise RuntimeError(f"BPE training failed (rc={rc})")
    return out_path


def load_reference(which: str = "mixed") -> SentencePieceProcessor:
    """Load one of the reference tokenizers: mixed | nucleotide | peptide."""
    path = os.path.join(REFERENCE_TOKENIZER_DIR, f"{which}_bpe.model")
    return SentencePieceProcessor(path)
