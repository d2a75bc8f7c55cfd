"""Streaming token-shard data pipeline (host side).

The port's own copy of `omnibiote_tpu/data/loader.py` (numpy only; the
native packer through the port's tokenizer library). Rework of the
reference's training/loader.py:
  * shard_reader()    == line_reader()   (loader.py:25-59)
  * pack_sequences()  == get_sequence()  (loader.py:118-163), both modes
  * mixture_batches() == get_batch()     (loader.py:165-181)

Differences from the reference (all deliberate):
  * seeded: every shuffle draws from an explicit np.random.Generator instead
    of the global numpy RNG, so runs are reproducible and the stream is
    checkpointable (the reference restarts data from scratch on resume,
    SURVEY.md §5);
  * checkpointable: state() / restore via the `state` constructor argument
    resumes at a shard-chunk boundary;
  * batches carry segment ids derived from EOS positions (ops/segments),
    replacing the reference's per-micro-batch O(B,T,T) mask build
    (train_encoder.py:290-292).

Packing semantics are reproduced exactly, including the reference's
token-dropping edge cases:
  * truncate mode: the overflowing line is cut to fill the row and its
    remainder is DISCARDED (loader.py:147-149);
  * padding mode: the overflowing line is discarded entirely, and a line
    longer than ctx_len is skipped (loader.py:140-146);
  * in both modes, the line pulled immediately after a row fills to exactly
    ctx_len is dropped on the floor (loader.py:131-136 pulls before checking).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..config import EOS_TOKEN, PAD_TOKEN
from ..ops.segments import segment_ids_np

# Number of shard files concatenated per read chunk (~100 MB/file in the
# reference corpus, loader.py:33).
CHUNK_FILES = 10


@dataclasses.dataclass
class ReaderState:
    """Resumable position of one data-pipeline stage, row-exact.

    Fields beyond (seed, epoch, chunk_idx) pin the position WITHIN a chunk
    so a mid-chunk resume replays nothing:
      * seq_idx:  permutation positions of the current chunk already
                  consumed by shard_reader (python path);
      * partial:  pack_sequences' pending partial row (python path);
      * row_idx:  rows of the current chunk already delivered
                  (native_row_stream);
      * carry:    the native packer's carry at the START of the current
                  chunk (native_row_stream re-packs the chunk and skips
                  row_idx rows);
      * batch_idx: batches emitted by mixture_batches (its per-batch row
                  shuffle is seeded by (seed, tag, batch_idx), so the
                  shuffle stream is position-exact too).
    Old checkpoints without these keys load with the defaults (chunk-
    granular resume, the previous behaviour).
    """
    seed: int
    epoch: int = 0
    chunk_idx: int = 0
    seq_idx: int = 0
    partial: Optional[List[int]] = None
    row_idx: int = 0
    carry: Optional[List[int]] = None
    batch_idx: int = 0

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)

    def copy(self) -> "ReaderState":
        return ReaderState(
            seed=self.seed, epoch=self.epoch, chunk_idx=self.chunk_idx,
            seq_idx=self.seq_idx,
            partial=None if self.partial is None else list(self.partial),
            row_idx=self.row_idx,
            carry=None if self.carry is None else list(self.carry),
            batch_idx=self.batch_idx)

    def assign(self, other: "ReaderState") -> None:
        """Copy every field of `other` into this (live) object."""
        for f in dataclasses.fields(self):
            v = getattr(other, f.name)
            setattr(self, f.name, list(v) if isinstance(v, list) else v)


def shard_reader(
    filenames: Sequence[str],
    banned_tokens: Sequence[int] = (),
    *,
    seed: int = 0,
    state: Optional[ReaderState] = None,
    chunk_files: int = CHUNK_FILES,
) -> Iterator[np.ndarray]:
    """Infinite generator of individual sequences (int32 arrays).

    Per epoch: shuffle shard order, load `chunk_files` files at a time,
    concatenate, split after each EOS, shuffle sequence order within the
    chunk, filter banned tokens, yield non-empty sequences
    (reference line_reader, loader.py:25-59).

    The generator exposes its resumable position via the `.state` attribute
    of the returned object (updated at chunk boundaries).
    """
    filenames = list(filenames)
    if not filenames:
        raise ValueError("need at least one shard file (an empty list "
                         "would spin the epoch loop forever)")
    st = state or ReaderState(seed=seed)
    banned = np.asarray(list(banned_tokens), dtype=np.int64)

    def gen():
        while True:
            # Epoch-level shuffle must be reproducible given (seed, epoch) so
            # (chunk_idx, seq_idx) pins the resume point exactly.
            rng = np.random.default_rng((st.seed, st.epoch))
            order = rng.permutation(len(filenames))
            chunks = [order[i:i + chunk_files]
                      for i in range(0, len(filenames), chunk_files)]
            while st.chunk_idx < len(chunks):
                chunk = chunks[st.chunk_idx]
                block = np.concatenate(
                    [np.load(filenames[i], mmap_mode=None) for i in chunk])
                eos_idx = np.where(block == EOS_TOKEN)[0]
                sub_blocks = np.split(block, eos_idx + 1)
                sub_rng = np.random.default_rng((st.seed, st.epoch, st.chunk_idx))
                perm = sub_rng.permutation(len(sub_blocks))
                # seq_idx counts PERMUTATION POSITIONS consumed (not yields),
                # so skipping on resume is a pure index slice; it is set
                # before each yield so a paused generator's state reflects
                # exactly the sequences already delivered.
                for pos in range(st.seq_idx, len(perm)):
                    sb = sub_blocks[perm[pos]]
                    if len(sb) == 0:
                        st.seq_idx = pos + 1
                        continue
                    if len(banned) == 1:
                        sb = sb[sb != banned[0]]
                    elif len(banned) > 1:
                        sb = sb[~np.isin(sb, banned)]
                    if len(sb):
                        st.seq_idx = pos + 1
                        yield sb.astype(np.int32)
                    else:
                        st.seq_idx = pos + 1
                st.chunk_idx += 1
                st.seq_idx = 0
            st.epoch += 1
            st.chunk_idx = 0

    class _Reader:
        """Iterator wrapper exposing the live resumable state."""
        state = st

        def __init__(self):
            self._g = gen()

        def __iter__(self):
            return self

        def __next__(self):
            return next(self._g)

    return _Reader()


def pack_sequences(
    reader: Iterator[np.ndarray],
    ctx_len: int,
    use_padding: bool = False,
    state: Optional[ReaderState] = None,
) -> Iterator[np.ndarray]:
    """Pack variable-length sequences into fixed ctx_len rows
    (reference get_sequence, loader.py:118-163; see module docstring for the
    reproduced edge cases).

    state: shares the reader's ReaderState. Row-exactness comes from the
    reader's seq_idx counting every consumed line (dropped or emitted): a
    generator can only pause at a yield, and both yield sites reset
    `sequence = []` before sync(), so the packer buffer is PROVABLY EMPTY at
    every checkpointable pause point — state.partial is kept (and restored
    below) only for forward-compat with a packer variant that carries
    overflow tokens across rows.
    """
    sequence: List[int] = []
    if state is not None and state.partial:
        sequence = list(state.partial)

    def sync():
        if state is not None:
            state.partial = list(sequence)

    while True:
        line = next(reader)
        seq_len = len(sequence)

        if seq_len == ctx_len:
            row = np.asarray(sequence, dtype=np.int32)
            sequence = []               # `line` dropped, as in the reference
            sync()
            yield row
            continue

        if seq_len + len(line) > ctx_len:
            if use_padding:
                if seq_len == 0:
                    continue  # line longer than ctx_len: skipped
                sequence.extend([PAD_TOKEN] * (ctx_len - seq_len))
            else:
                sequence.extend(line[:ctx_len - seq_len].tolist())
            row = np.asarray(sequence, dtype=np.int32)
            sequence = []
            sync()
            yield row
            continue

        sequence.extend(line.tolist())


def mixture_batches(
    generators: Sequence[Iterator[np.ndarray]],
    counts: Sequence[int],
    *,
    seed: int = 0,
    with_segments: bool = True,
    state: Optional[ReaderState] = None,
) -> Iterator[dict]:
    """Deterministic per-batch corpus mixture (reference get_batch,
    loader.py:165-181): pull counts[i] rows from generators[i], shuffle row
    order, emit {'tokens': (B,T) int32, 'segments': (B,T) int32}.

    The row shuffle is seeded per batch from (seed, tag, batch_idx), so a
    resume at state.batch_idx reproduces the exact shuffle stream without
    replaying earlier draws."""
    st = state or ReaderState(seed=seed)
    while True:
        rows = []
        for gen_i, n in zip(generators, counts):
            for _ in range(n):
                rows.append(next(gen_i))
        rng = np.random.default_rng((seed, 0xBA7C4, st.batch_idx))
        batch = np.stack(rows)
        batch = batch[rng.permutation(len(batch))]
        out = {"tokens": batch}
        if with_segments:
            out["segments"] = segment_ids_np(batch)
        st.batch_idx += 1
        yield out


def batch_split(batch_size: int, proportions: Sequence[float]) -> List[int]:
    """Per-corpus row counts for one batch (train_encoder.py:120-124)."""
    split = [int(p * batch_size) for p in proportions]
    if sum(split) != batch_size:
        split[-1] += batch_size - sum(split)
    return split


def list_shards(base_dir: str, rel_dirs: Sequence[str]) -> List[List[str]]:
    """Enumerate .npy shard files per corpus dir (train_encoder.py:95-99).

    Only *.npy entries are returned (a stray editor/temp file would crash
    np.load chunks later mid-training), and an empty corpus dir fails HERE
    with a clear message — downstream, an empty shard list would spin the
    epoch loop forever without yielding."""
    out = []
    for rel in rel_dirs:
        d = os.path.join(base_dir, rel)
        files = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.endswith(".npy"))
        if not files:
            raise FileNotFoundError(
                f"no .npy token shards in {d!r} — run the preprocessing "
                "tokenize step (omnibiote_tpu.preprocessing.tokenize_corpus)"
                " first")
        out.append(files)
    return out


def build_pipeline(
    base_dir: str,
    rel_dirs: Sequence[str],
    proportions: Sequence[float],
    *,
    batch_size: int,
    ctx_len: int,
    use_padding: bool = False,
    banned_tokens: Sequence[int] = (),
    seed: int = 0,
    reader_states: Optional[List[ReaderState]] = None,
    num_hosts: int = 1,
    host_id: int = 0,
):
    """Wire reader -> packer -> mixture batcher for a corpus mixture.

    Returns (batch_iterator, reader_states) where reader_states are live
    objects whose contents advance with the stream (checkpoint them).

    Per-host sharded feeding (num_hosts > 1): host `host_id` reads a
    DISJOINT stripe of every corpus's shard files (files[host_id::num_hosts])
    and emits `batch_size // num_hosts` rows per batch — host work scales
    1/num_hosts with pod size instead of every host assembling the whole
    global batch (the reference's per-rank `batch_size // world_size`
    generator chains, train_encoder.py:118-133). The port's Trainer feeds
    one host (num_hosts=1); the striping is kept so its streams equal the
    JAX package's."""
    if not (0 <= host_id < num_hosts):
        raise ValueError(f"host_id {host_id} not in [0, {num_hosts})")
    if batch_size % num_hosts:
        raise ValueError(f"batch_size {batch_size} must divide by "
                         f"num_hosts {num_hosts}")
    shard_lists = list_shards(base_dir, rel_dirs)
    if num_hosts > 1:
        for rel, files in zip(rel_dirs, shard_lists):
            if len(files) < num_hosts:
                raise ValueError(
                    f"corpus {rel!r} has {len(files)} shard files — fewer "
                    f"than num_hosts={num_hosts}; per-host striping needs at "
                    "least one file per host (re-tokenize with a smaller "
                    "shard_tokens, or run fewer data hosts)")
        shard_lists = [files[host_id::num_hosts] for files in shard_lists]
        batch_size = batch_size // num_hosts
        # disjoint files already separate the hosts' data; distinct seeds
        # additionally decorrelate the within-chunk shuffles
        seed = seed + 100_003 * host_id
    # states: one per corpus reader (shared with its packer) + a final one
    # for the mixture shuffle position
    if reader_states and len(reader_states) == len(shard_lists):
        # legacy checkpoint without the mixture state: append a fresh one.
        # Compat caveat: such a resume gets chunk-granular
        # reader positions AND a mixture-shuffle stream restarted at
        # batch_idx=0 — deterministic, but not a continuation of the
        # pre-checkpoint shuffle order (per-batch reseeding draws from
        # (seed, tag, batch_idx), not a consumed rng stream).
        states = list(reader_states) + [ReaderState(seed=seed)]
    else:
        states = reader_states or (
            [ReaderState(seed=seed + 1000 * i)
             for i in range(len(shard_lists))] + [ReaderState(seed=seed)])
    readers = [
        shard_reader(files, banned_tokens, state=st)
        for files, st in zip(shard_lists, states)]
    packers = [pack_sequences(r, ctx_len, use_padding, state=st)
               for r, st in zip(readers, states)]
    counts = batch_split(batch_size, proportions)
    return (mixture_batches(packers, counts, seed=seed, state=states[-1]),
            states)


def pack_lines_native(lines, ctx_len: int, use_padding: bool = False):
    """Batch-pack a list of token lines with the C++ packer.

    Bit-identical to pack_sequences for the same line order (including the
    reference's drop semantics); also returns per-row segment ids. Returns
    (rows (N, ctx), segs (N, ctx), consumed_lines) where lines[consumed:]
    belong to the pending partial row and must be re-fed on the next call.
    """
    import ctypes
    from ..tokenizer import _load_lib

    lib = _load_lib()
    flat = (np.concatenate(lines) if lines else
            np.zeros((0,), np.int32)).astype(np.int32)
    offsets = np.zeros(len(lines) + 1, np.int64)
    np.cumsum([len(l) for l in lines], out=offsets[1:])
    # Capacity is provably sufficient under the reference flush semantics
    # (every flushed row consumes > ctx tokens, counting the dropped
    # overflow line — module docstring), but the C++ packer silently drops
    # lines past capacity, so a semantics change here would mean silent
    # corpus loss: retry with doubled capacity whenever the returned row
    # count hits the cap (defensive)
    cap_rows = max(1, int(offsets[-1]) // max(ctx_len, 1) + 1)
    while True:
        rows = np.zeros((cap_rows, ctx_len), np.int32)
        segs = np.zeros((cap_rows, ctx_len), np.int32)
        consumed = ctypes.c_long(0)
        n = lib.obt_pack_lines(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
            len(lines), ctx_len, int(use_padding),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            cap_rows, ctypes.byref(consumed))
        if n < cap_rows:
            return rows[:n], segs[:n], int(consumed.value)
        cap_rows *= 2


class NativePacker:
    """Streaming wrapper over the C++ packer: feed(lines) -> packed rows,
    carrying the pending partial row across calls."""

    def __init__(self, ctx_len: int, use_padding: bool = False):
        self.ctx_len = ctx_len
        self.use_padding = use_padding
        self._pending: List[np.ndarray] = []

    def feed(self, lines):
        all_lines = self._pending + list(lines)
        rows, segs, consumed = pack_lines_native(
            all_lines, self.ctx_len, self.use_padding)
        self._pending = all_lines[consumed:]
        return rows, segs


def native_chunk_rows(
    filenames: Sequence[str],
    banned_tokens: Sequence[int] = (),
    *,
    ctx_len: int,
    use_padding: bool = False,
    seed: int = 0,
    state: Optional[ReaderState] = None,
    chunk_files: int = CHUNK_FILES,
):
    """Native-pipeline row stream: the whole chunk stage (EOS split, banned
    filter, order shuffle, packing, segment ids) runs in one C++ pass
    (tokenizer/cpp/packer.cc obt_pack_chunk). Semantics match shard_reader +
    pack_sequences except the line shuffle uses its own seeded generator.

    Yields (rows, segs) ndarray pairs per chunk; CHUNK-granular resume via
    ReaderState (epoch/chunk position AND the packer carry — without the
    carry a resume would re-pack with an empty partial row and silently
    diverge from the uninterrupted stream). For row-exact
    resume use native_row_stream.
    """
    import ctypes
    from ..tokenizer import _load_lib

    lib = _load_lib()
    filenames = list(filenames)
    if not filenames:
        raise ValueError("need at least one shard file (an empty list "
                         "would spin the epoch loop forever)")
    st = state or ReaderState(seed=seed)
    banned = np.asarray(list(banned_tokens), np.int32)
    carry = np.zeros(ctx_len, np.int32)
    carry_len = ctypes.c_int(0)
    if st.carry:
        carry[:len(st.carry)] = np.asarray(st.carry, np.int32)
        carry_len.value = len(st.carry)

    while True:
        rng = np.random.default_rng((st.seed, st.epoch))
        order = rng.permutation(len(filenames))
        chunks = [order[i:i + chunk_files]
                  for i in range(0, len(filenames), chunk_files)]
        while st.chunk_idx < len(chunks):
            rows, segs = _native_pack_one_chunk(
                lib, filenames, chunks[st.chunk_idx], banned, st, ctx_len,
                use_padding, carry, carry_len)
            st.chunk_idx += 1
            st.carry = carry[:carry_len.value].tolist()
            if len(rows):
                yield rows, segs
        st.epoch += 1
        st.chunk_idx = 0


def _native_pack_one_chunk(lib, filenames, chunk, banned, st, ctx_len,
                           use_padding, carry, carry_len):
    """Run obt_pack_chunk over one shard chunk, updating carry in place."""
    import ctypes

    block = np.ascontiguousarray(np.concatenate(
        [np.load(filenames[i]) for i in chunk]).astype(np.int32))
    shuffle_seed = (st.seed * 1_000_003 + st.epoch * 97 +
                    st.chunk_idx) & 0xFFFFFFFFFFFFFFFF
    # Capacity is provably sufficient under the reference flush semantics
    # (every flushed row consumes > ctx tokens incl. the dropped overflow
    # line), but the C++ packer drops lines past capacity silently, so
    # guard against a future semantics change: the call mutates carry, so
    # snapshot it and retry the whole chunk with doubled capacity when the
    # returned row count hits the cap (defensive)
    snap = carry[:carry_len.value].copy()
    snap_len = carry_len.value
    cap = len(block) // max(ctx_len, 1) + 2
    while True:
        rows = np.zeros((cap, ctx_len), np.int32)
        segs = np.zeros((cap, ctx_len), np.int32)
        n = lib.obt_pack_chunk(
            block.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(block),
            banned.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            len(banned), shuffle_seed, ctx_len, int(use_padding),
            carry.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            ctypes.byref(carry_len),
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            segs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap)
        if n < cap:
            return rows[:n], segs[:n]
        carry[:] = 0
        carry[:snap_len] = snap
        carry_len.value = snap_len
        cap *= 2


def native_row_stream(
    filenames: Sequence[str],
    banned_tokens: Sequence[int] = (),
    *,
    ctx_len: int,
    use_padding: bool = False,
    seed: int = 0,
    state: Optional[ReaderState] = None,
    chunk_files: int = CHUNK_FILES,
):
    """Row-level native stream with ROW-EXACT resume.

    Yields one (row, seg) pair at a time. ReaderState carries, in addition
    to (seed, epoch, chunk_idx):
      * carry:   the packer carry at the START of the current chunk;
      * row_idx: rows of the current chunk already delivered.
    A resume re-packs the current chunk from the saved pre-chunk carry
    (host-side, cheap) and skips the delivered rows — the continued stream
    is bit-identical to an uninterrupted one. Returns a _Reader-style
    object exposing `.state`. Replaces the reference's restart-from-scratch
    stream (the reference's loader.py:25-59, SURVEY.md §5).
    """
    import ctypes
    from ..tokenizer import _load_lib

    lib = _load_lib()
    filenames = list(filenames)
    if not filenames:
        raise ValueError("need at least one shard file (an empty list "
                         "would spin the epoch loop forever)")
    st = state or ReaderState(seed=seed)
    banned = np.asarray(list(banned_tokens), np.int32)

    def gen():
        carry = np.zeros(ctx_len, np.int32)
        carry_len = ctypes.c_int(0)
        if st.carry:
            carry[:len(st.carry)] = np.asarray(st.carry, np.int32)
            carry_len.value = len(st.carry)
        resume_skip = st.row_idx
        while True:
            rng = np.random.default_rng((st.seed, st.epoch))
            order = rng.permutation(len(filenames))
            chunks = [order[i:i + chunk_files]
                      for i in range(0, len(filenames), chunk_files)]
            while st.chunk_idx < len(chunks):
                # snapshot the pre-chunk carry: this is what a mid-chunk
                # resume needs to re-pack the chunk identically
                st.carry = carry[:carry_len.value].tolist()
                rows, segs = _native_pack_one_chunk(
                    lib, filenames, chunks[st.chunk_idx], banned, st,
                    ctx_len, use_padding, carry, carry_len)
                start = resume_skip
                resume_skip = 0
                for i in range(start, len(rows)):
                    # set BEFORE the yield: a paused generator's state says
                    # exactly how many rows are out
                    st.row_idx = i + 1
                    yield rows[i], segs[i]
                st.chunk_idx += 1
                st.row_idx = 0
            st.epoch += 1
            st.chunk_idx = 0

    class _Rows:
        state = st

        def __init__(self):
            self._g = gen()

        def __iter__(self):
            return self

        def __next__(self):
            return next(self._g)

    return _Rows()
