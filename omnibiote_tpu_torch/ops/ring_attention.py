"""Ring attention: sequence-parallel attention over a mesh axis.

Port of `omnibiote_tpu/ops/ring_attention.py`. The sequence is cut over the
mesh's 'seq' axis: ring member i holds rows [i·Tl, (i+1)·Tl) of every
sequence of its batch rows, as q, k and v of shape (B, Tl, H, D). The k/v
blocks go round the ring, one member on at each of the N - 1 rotations
(`_Rotate`: `torch.distributed` P2P to member i + 1, from member i - 1; its
backward sends the gradients the other way), and each member folds every
block into its queries' softmax. The segment ids are global (a packed row's
EOS count over the whole sequence), so masking across the cut is the
whole sequence's.

Two bodies share the online-softmax math, as in the JAX package:

  * `ring_body_flash`: each rotation's attention is `flash_attention_lse`
    (the CUDA kernels #1-#5 on a CUDA tensor) with the q rows' ids and the
    rotated block's, and the blocks' (o_r, lse_r) recombine by a running
    max: o = Σ o_r·e^{lse_r} / Σ e^{lse_r}. The combine's lse cotangent
    reaches the kernels through di;
  * `ring_body_plain`: the same online softmax in plain PyTorch (the JAX
    package's `_ring_body`), the oracle of the flash body.

`ring_attention` takes the flash body where the block is lane-aligned
(Tl % 128 == 0 and D % 128 == 0), the JAX package's rule.

The ids are not rotated: `RingSegments` all-gathers them over the seq axis
once per forward and builds the N rotations' `SegmentBounds` (q ids against
the ids of the block that rotation brings), with the tiles every kernel
will ask for computed there. The model makes one per micro-batch and every
layer reads it in both directions, so no attention call in the ring
computes skip bounds of its own.

Dropout on the probabilities: rotation r of ring member m (its seq index
plus N times its data index) takes the seed `ring_seed(seed, m, r)`, the
counterpart of the JAX package's fold_in(fold_in(key, m), r). Both bodies
draw the kernels' Philox masks from it, so the plain body is the flash
body's oracle at any rate; the TPU's streams cannot be reproduced.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import flash_attention as _fa
from .flash_attention import (DEFAULT_MASK_VALUE, KERNEL_DTYPES, SegmentBounds,
                              dropout_keep, dropout_keep_scale,
                              flash_attention_lse)

# one sentinel across kernels, as in the JAX package: the plain body is the
# flash body's oracle, so their masked-score magnitude must not drift apart
NEG_BIG = DEFAULT_MASK_VALUE


class Ring(NamedTuple):
    """A rank's place on the ring: the seq axis's group (None for a ring of
    one), its index and size there, its data-axis index (the dropout
    streams of two data rows differ), and the global ranks of the members
    it sends to and receives from."""
    group: object
    index: int
    size: int
    data_index: int = 0
    send_to: int = 0
    recv_from: int = 0

    @property
    def member(self) -> int:
        """The JAX package's `my_idx`: seq index + N·data index."""
        return self.index + self.size * self.data_index


def ring_of(mesh, seq_axis: str = "seq", batch_axis: Optional[str] = None) -> Ring:
    """This rank's Ring on `seq_axis` of a DeviceMesh (a ring of one
    without a mesh or without that axis); batch_axis: the axis the batch
    rows are cut on (dp x sp), whose index keys the dropout streams."""
    from ..parallel.mesh import axis_group, axis_index, axis_size

    n = axis_size(mesh, seq_axis)
    data_index = axis_index(mesh, batch_axis) if batch_axis else 0
    if n == 1:
        return Ring(None, 0, 1, data_index)
    group, i = axis_group(mesh, seq_axis), axis_index(mesh, seq_axis)
    return Ring(group, i, n, data_index,
                dist.get_global_rank(group, (i + 1) % n),
                dist.get_global_rank(group, (i - 1) % n))


def ring_seed(seed: int, member: int, step: int) -> int:
    """The attention dropout seed of rotation `step` on ring member
    `member`."""
    return int(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFFFFFFFFFF, int(member), int(step)])
        .generate_state(1, np.uint64)[0])


def _shift(ring: Ring, tensors: Sequence[torch.Tensor], forward: bool):
    """Each tensor sent one member on (back with forward=False), and the
    one that arrives in its place. P2P on the default group with global
    peer ranks, so a lost peer fails at that group's timeout."""
    to, frm = ((ring.send_to, ring.recv_from) if forward
               else (ring.recv_from, ring.send_to))
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format)
            for t in tensors]
    ops = []
    for t, o in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), to))
        ops.append(dist.P2POp(dist.irecv, o, frm))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return outs


class _Rotate(torch.autograd.Function):
    """(k, v) of member i - 1 in place of member i's; the backward sends
    the gradients back to where the blocks came from."""

    @staticmethod
    def forward(ctx, ring, k, v):
        ctx.ring = ring
        return tuple(_shift(ring, (k, v), True))

    @staticmethod
    def backward(ctx, dk, dv):
        return (None, *_shift(ctx.ring, (dk, dv), False))


def rotated_blocks(k, v, ring: Ring) -> Callable[[int], tuple]:
    """r -> (k, v) of the block that rotation r brings to this member
    (member index - r's), rotating on demand; call with r = 0, 1, ..."""
    state = {"r": 0, "kv": (k, v)}

    def block(r: int):
        while state["r"] < r:
            state["kv"] = _Rotate.apply(ring, *state["kv"])
            state["r"] += 1
        return state["kv"]

    return block


class RingSegments:
    """The q rows' ids (B, Tl), the ids of the kv block each rotation
    brings (kv_ids[r]: member index - r's rows; None at r = 0, the member's
    own block, where q and kv share one array) and one SegmentBounds a
    rotation. `gather` builds it from one all-gather of the ids over the
    seq axis; `prefill` computes the bounds of the tiles a path will walk,
    so the attention calls only read them."""

    def __init__(self, q_ids: torch.Tensor, kv_ids: Sequence[Optional[torch.Tensor]]):
        self.q_ids = q_ids.to(torch.int32).contiguous()
        self.kv_ids: List[Optional[torch.Tensor]] = [
            None if kv is None else kv.to(torch.int32).contiguous() for kv in kv_ids]
        self.bounds = [SegmentBounds(self.q_ids, kv) for kv in self.kv_ids]

    @classmethod
    def gather(cls, segment_ids: torch.Tensor, ring: Ring) -> "RingSegments":
        """This member's RingSegments: every member's (B, Tl) ids by one
        all-gather over the seq axis."""
        ids = segment_ids.to(torch.int32).contiguous()
        if ring.size == 1:
            return cls(ids, [None])
        flat = torch.empty((ring.size * ids.shape[0], ids.shape[1]),
                           dtype=ids.dtype, device=ids.device)
        dist.all_gather_into_tensor(flat, ids, group=ring.group)
        blocks = flat.view(ring.size, *ids.shape).unbind(0)
        return cls(ids, [None] + [blocks[(ring.index - r) % ring.size]
                                  for r in range(1, ring.size)])

    def prefill(self, dtype: torch.dtype, device_type: str, block_q: int,
                block_kv: int, head_dim: int) -> None:
        """Fill every rotation's bounds for the flash body's calls, each
        tile pair for all rotations by one seg_block_bounds over the
        rotations stacked on the batch axis: on CUDA the kernels' tiles at
        `head_dim` (the forward's and, kv-major, the fused or dkv kernel's;
        the dq kernel's where the backward is the split pair), on the CPU the plain
        versions' (block_q, block_kv). A pair already filled is skipped,
        so every layer may call this."""
        single_kv = block_kv >= self.q_ids.shape[1]
        fused = _fa.FUSED_SINGLE_KV_BWD if single_kv else _fa.FUSED_MULTIKV_BWD
        if device_type == "cuda":
            if dtype not in KERNEL_DTYPES:
                return
            (fq, fkv), (bq, bkv), (dq, dkv) = (_fa.kernel_tiles(k, dtype, head_dim)
                                               for k in ("fwd", "fused", "dq"))
            pairs = [(fq, fkv, False), (bkv, bq, True)] + ([] if fused else [(dq, dkv, False)])
        else:
            pairs = [(block_q, block_kv, False), (block_kv, block_q, True)]
        n, B = len(self.bounds), self.q_ids.shape[0]
        q_all = self.q_ids.repeat(n, 1)
        kv_all = torch.cat([self.q_ids if kv is None else kv for kv in self.kv_ids])
        for a, b, kv_major in pairs:
            if all(sb.key(a, b, kv_major) in sb._memo for sb in self.bounds):
                continue
            lo, hi = _fa.seg_block_bounds(*((kv_all, q_all) if kv_major else (q_all, kv_all)),
                                          a, b)
            for r, sb in enumerate(self.bounds):
                sb._memo[sb.key(a, b, kv_major)] = (lo[r * B:(r + 1) * B],
                                                    hi[r * B:(r + 1) * B])


def ring_body_plain(q, blocks: Callable[[int], tuple], n: int, q_ids=None,
                    kv_ids: Optional[Sequence] = None, *, scale: float,
                    dropout_rate: float = 0.0, seeds: Sequence[int] = ()):
    """The JAX package's `_ring_body`: the online softmax over the n blocks
    that `blocks(r)` gives (r = 0 .. n-1), in fp32, with NEG_BIG on unequal
    ids (kv_ids[r]: rotation r's kv ids, None for the q rows' own), and
    each rotation's dropout from the kernels' Philox stream at seeds[r].
    q (B, Tl, H, D) -> o in q's dtype."""
    B, Tl, H, D = q.shape
    m = torch.full((B, H, Tl, 1), -float("inf"), device=q.device)
    l = torch.zeros((B, H, Tl, 1), device=q.device)
    o = torch.zeros((B, Tl, H, D), device=q.device)
    qf = q.float()
    for r in range(n):
        k_blk, v_blk = blocks(r)
        s = torch.einsum("bthd,bshd->bhts", qf, k_blk.float()) * scale
        if q_ids is not None:
            kv = q_ids if kv_ids is None or kv_ids[r] is None else kv_ids[r]
            vis = q_ids[:, :, None] == kv[:, None, :]
            s = torch.where(vis[:, None], s, NEG_BIG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if dropout_rate > 0.0:
            keep = dropout_keep(seeds[r], dropout_rate, B, H, Tl, 0, Tl, q.device)
            p = torch.where(keep, p * dropout_keep_scale(dropout_rate), 0.0)
        o = o * alpha.transpose(1, 2) + torch.einsum(
            "bhts,bshd->bthd", p.to(v_blk.dtype).float(), v_blk.float())
        m = m_new
    l_t = l.transpose(1, 2)
    return (o / torch.where(l_t == 0.0, 1.0, l_t)).to(q.dtype)


def ring_body_flash(q, blocks: Callable[[int], tuple], n: int, q_ids=None,
                    segments: Optional[RingSegments] = None, *, scale: float,
                    dropout_rate: float = 0.0, seeds: Sequence[int] = (),
                    block_q: int, block_kv: int):
    """The JAX package's `_ring_body_flash`: rotation r's (o_r, lse_r) from
    `flash_attention_lse` on the q rows and the block `blocks(r)` (its ids
    and bounds from `segments`), recombined in fp32 as Σ o_r·e^{lse_r - m} /
    Σ e^{lse_r - m}. The running max m only keeps the exponents in range:
    the result does not depend on it, so it carries no gradient, and a ring
    of one returns o_0 itself. block_q and block_kv set the plain versions'
    tiles and the backward's case (single-kv where block_kv spans Tl); no
    RoPE (q and k arrive rotated)."""
    q = q.contiguous()          # the kernels read whole rows
    for r in range(n):
        k_blk, v_blk = (x.contiguous() for x in blocks(r))
        kw = {}
        if q_ids is not None:
            kw = dict(kv_segment_ids=segments.kv_ids[r], bounds=segments.bounds[r])
        o_r, lse_r = flash_attention_lse(
            q, k_blk, v_blk, q_ids, None, scale=scale,
            dropout_rate=dropout_rate, seed=seeds[r] if dropout_rate > 0 else 0,
            block_q=block_q, block_kv=block_kv, segment_skip=True, **kw)
        if n == 1:
            return o_r
        if r == 0:
            m = lse_r.detach()
            w = torch.exp(lse_r - m)
            num, den = o_r.float() * w[..., None], w
            continue
        m_new = torch.maximum(m, lse_r.detach())
        alpha = torch.exp(m - m_new)
        w = torch.exp(lse_r - m_new)
        num = num * alpha[..., None] + o_r.float() * w[..., None]
        den = den * alpha + w
        m = m_new
    return (num / torch.where(den == 0.0, 1.0, den)[..., None]).to(q.dtype)


def ring_blocks(T: int) -> tuple:
    """(block_q, block_kv) of the flash body at ring block length T: the
    JAX package's _fit_block(T, 512) and _fit_block(T, 1024)."""
    from .attention import _fit_block
    return _fit_block(T, 512), _fit_block(T, 1024)


def ring_attention(q, k, v, segment_ids=None, *, scale: float, mesh=None,
                   seq_axis: str = "seq", batch_axis: Optional[str] = None,
                   dropout_rate: float = 0.0, seed: Optional[int] = 0,
                   use_flash: Optional[bool] = None,
                   segments: Optional[RingSegments] = None, ring: Optional[Ring] = None):
    """Sequence-parallel attention of this rank's block: q, k, v (B, Tl, H,
    D) rows [i·Tl, (i+1)·Tl) of ring member i on `seq_axis` of `mesh`,
    RoPE already applied at their global positions; segment_ids (B, Tl)
    their global ids or None (dense). batch_axis: the dp x sp axis the
    batch rows are cut on. segments: the forward's RingSegments of these
    ids (built here when not given); ring: this rank's Ring (from the mesh
    when not given). use_flash None takes the flash body where Tl % 128 ==
    0 and D % 128 == 0. Returns o (B, Tl, H, D)."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    ring = ring if ring is not None else ring_of(mesh, seq_axis, batch_axis)
    B, Tl, H, D = q.shape
    n = ring.size
    if segment_ids is not None and segments is None:
        segments = RingSegments.gather(segment_ids, ring)
    q_ids = None if segments is None else segments.q_ids
    seeds = [ring_seed(seed, ring.member, r) if dropout_rate > 0 else 0
             for r in range(n)]
    blocks = rotated_blocks(k, v, ring) if n > 1 else (lambda r: (k, v))
    if use_flash is None:
        use_flash = Tl % 128 == 0 and D % 128 == 0
    if use_flash:
        block_q, block_kv = ring_blocks(Tl)
        if segments is not None:
            segments.prefill(q.dtype, q.device.type, block_q, block_kv, D)
        return ring_body_flash(q, blocks, n, q_ids, segments, scale=scale,
                               dropout_rate=dropout_rate, seeds=seeds,
                               block_q=block_q, block_kv=block_kv)
    return ring_body_plain(q, blocks, n, q_ids,
                           None if segments is None else segments.kv_ids,
                           scale=scale, dropout_rate=dropout_rate, seeds=seeds)
