"""Multi-head flash attention: the CUDA kernels' wrappers, their plain
PyTorch versions, the dropout stream they share, and the autograd Function
that joins forward and backward.

Port of `omnibiote_tpu/ops/flash_attention.py`: the forward `_mh_fwd`
(Pallas kernel `_mh_fwd_kernel`), the backward `_mh_bwd` with its fused
kernels (`_mh_bwd_fused_kernel` where one kv block spans the sequence,
`_mh_bwd_fusedmk_kernel` above that) and its split pair
(`_mh_bwd_dkv_kernel`, `_mh_bwd_dq_kernel`), the segment-skip bounds
`_seg_block_bounds`, and the lse-exposing variant `_flash_mh_lse`.
Bidirectional attention over (B, T, H, D) q/k/v with rotate-half RoPE
fused in, segment-id masking, dropout on P and a log2-space logsumexp
residual. The kernels are `ops/csrc/mh_flash_fwd.cu`, `mh_flash_bwd.cu`
(both fused cases), `mh_flash_bwd_dkv.cu` and `mh_flash_bwd_dq.cu`, each
built at head dims 64, 128 and 256, and past 256 at every multiple of 128.
There the bf16 forward up to WIDE_FWD_MAX_HEAD_DIM (`mh_fwd_wide_wgmma`)
gives a CTA 64 q rows and all D lanes, two consumer warpgroups splitting
the scores' reduction and the output's lanes in halves (each product done
once); at PAIR_BWD_HEAD_DIMS the bf16 backwards are those of
`ops/csrc/mh_flash_bwd_pair.cuh`: the fused kernel and the split pair's dkv
kernel (`mh_bwd_pair`, with and without dQ) give a thread-block cluster a
64-row kv tile, each CTA a part of the head dim closed under rotate-half
(`pair_part_lanes`), the partial scores summed through distributed shared
memory (S^T formed twice a CTA, every other product once); the dq kernel
(`mh_bwd_dq_cta`) gives one CTA a 64-row q tile with all D lanes, its two
consumers splitting the scores' reduction and dQ's lanes (each product
once); the fp32 backward
kernels and the bf16 ones past those head dims are those of
`ops/csrc/wide_attention.cuh`: a CTA owns one 128-lane slice of the
output (lanes [64c, 64c + 64) and [D/2 + 64c, D/2 + 64c + 64), closed under
rotate-half) and recomputes the products over the whole head dim from
streamed panels.

`flash_attention(multi_head=False)` is the JAX package's per-head entry
(`_flash`: `_fwd_kernel`, `_bwd_dkv_kernel`, `_bwd_dq_kernel`, a (B, H,
T/bq, T/bkv) grid): no RoPE, no segment skipping, and a backward that is
always the split pair. What those TPU kernels compute is what the forward
kernel and the split pair here compute without RoPE tables and without
bounds, so on a CUDA tensor the same sources serve it, counted under
`flash_fwd`, `flash_bwd_dkv` and `flash_bwd_dq`. Their inner differences
(a natural-log lse residual, a `where` mask in place of the additive one,
the grid) are not visible outside and have no counterpart.

The kernels take T in multiples of KERNEL_T_MULTIPLE[dtype]; the JAX
entries take any T their blocks divide. On a CUDA tensor at another T,
`flash_attention` (either entry) zero-pads the rows to the next multiple
and gives the pad rows a segment id of their own
(`flash_attention_padded_t`): the mask keeps every real row's softmax to
the real keys, the skip bounds prune the all-pad tiles, and the dropout
stream draws the unpadded call's mask. The wrappers themselves still
refuse such a T.

Numerics (identical in the kernels and the plain versions):
  * RoPE rotates q and k in fp32 from the cos/sin tables, and the result is
    rounded to the input dtype before the products;
  * scores in fp32, s2 = (q·kᵀ)·(scale·log2e) + bias, with bias 0 on equal
    segment ids and DEFAULT_MASK_VALUE (finite, -0.7·f32max) otherwise, so a
    fully masked row attends uniformly (the mean of V) instead of NaN;
  * exp2-based softmax; P is rounded to the input dtype before P·V, the
    product accumulates in fp32, and o = acc · (1/l) in the input dtype;
  * lse2 = m + log2(l), (B, T, H) fp32, the backward's residual;
  * dropout: keep iff the element's 32 random bits >= ⌊rate·2³²⌋ (the JAX
    package's rule); kept values are scaled by 1/(1-rate) after l has
    summed the undropped p. The bits are Philox4x32-10 keyed by the call's
    64-bit seed with a counter built from (b·H + h, i, j), so the mask is a
    pure function of (seed, b, h, i, j): the same in forward and backward,
    in the kernels and here, whatever the tiles (`dropout_bits`). The TPU's
    in-kernel generator cannot be reproduced, so the port's masks are not
    the JAX package's;
  * backward: p = exp2(s2 - lse2), dp = do·vᵀ in fp32, p_drop and dp masked
    and scaled, ds = p·(dp - di)·scale from the undropped p with
    di = rowsum(o·do) in fp32; p_drop and ds rounded to the input dtype as
    product operands; inverse RoPE on the fp32 dq and dk before the cast;
  * segment skipping: a (q tile, kv tile) pair whose segment-id ranges are
    disjoint is fully masked and is not visited (`seg_block_bounds`). Such
    a tile contributes exact zeros (its p underflows to 0 against a visible
    score, and the online softmax's alpha wipes a leading masked tile), so
    with one ids array for q and kv (every row sees itself) skipping
    changes no bit of o, lse2, dq, dk or dv in the plain versions, the
    forward kernel and the split pair; the fused kernel's dq differs only
    as its atomic sums do from run to run;
  * separate q and kv ids (`kv_segment_ids`, the ring's rotated kv block,
    the JAX package's `_flash_mh_lse(q_seg, kv_seg)`): the mask is
    q_seg[i] == kv_seg[j] and the bounds are those of the pair. A q row that
    sees no key of the block averages V over the tiles it walks and gets
    an lse near DEFAULT_MASK_VALUE·ln2, so its o and lse depend on
    skipping; every other bit is as above when such rows carry no
    cotangent, which is what the ring's lse combine gives them (a weight
    e^{lse - max} that is exactly 0).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634

# The head dims with kernel instances of their own (one template instance
# each); past 256 one set of instances takes every multiple of
# WIDE_HEAD_DIM_MULTIPLE, the head dim a run-time size (ops/csrc/
# wide_attention.cuh). `kernel_head_dim` is the test every caller uses.
KERNEL_HEAD_DIMS = (64, 128, 256)
WIDE_HEAD_DIM_MULTIPLE = 128
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# The forward kernel's kv tile per dtype at head dims 64 and 128 (its online
# softmax rounds P per tile); `kernel_kv_tile` gives it at any built D.
KERNEL_KV_TILE = {torch.bfloat16: 128, torch.float32: 32}
# (q tile, kv tile) of each kernel per dtype at head dims 64 and 128 (but
# the fp32 dq kernel's at 64: KERNEL_TILES_BY_HEAD_DIM): the forward and
# the dq kernel own a q tile and walk kv tiles; the fused backward and the
# dkv kernel own a kv tile and walk q tiles. The dkv kernel is the fused
# kernel without its dq, on the same tiles, in both dtypes; the fp32 dq
# kernel keeps a 64-row q tile's Q and dO in shared memory, the fp32
# forward its 64-row Q, the fp32 fused kernel its 64 kv rows' K and V
# (3xTF32 on the tensor cores, mma.sync's 16-row fragments a warp).
KERNEL_TILES = {
    "fwd": {torch.bfloat16: (128, 128), torch.float32: (64, 32)},
    "fused": {torch.bfloat16: (64, 128), torch.float32: (32, 64)},
    "dkv": {torch.bfloat16: (64, 128), torch.float32: (32, 64)},
    "dq": {torch.bfloat16: (128, 64), torch.float32: (64, 64)},
}
# The tiles at the head dims where they differ (every reader goes through
# `kernel_tiles`). At D = 256 a 128-row K and V ring, or dK and dV of 64 kv
# rows in one warpgroup, pass the H100's shared memory or registers: the
# bf16 forward walks 64-row kv tiles, the fused and dkv kernels own 64 kv
# rows (one consumer forms dV, the other dK), the dq kernel walks 32-row kv
# tiles; the fp32 fused and dkv kernels walk 16-row q tiles (eight warps,
# two head-dim parts; K and V of 64 kv rows are 130 KB), the fp32 dq kernel
# 16-row kv tiles (a two-stage K and V ring beside the 128 KB of its q
# tile's Q and dO). At D = 64 the fp32 dq kernel walks 32-row kv tiles on
# four warps (two CTAs an SM), measured faster there than D = 128's 64-row
# tiles on eight.
KERNEL_TILES_BY_HEAD_DIM = {
    256: {
        "fwd": {torch.bfloat16: (128, 64), torch.float32: (64, 32)},
        "fused": {torch.bfloat16: (64, 64), torch.float32: (16, 64)},
        "dkv": {torch.bfloat16: (64, 64), torch.float32: (16, 64)},
        "dq": {torch.bfloat16: (128, 32), torch.float32: (64, 16)},
    },
    64: {**KERNEL_TILES, "dq": {torch.bfloat16: (128, 64), torch.float32: (64, 32)}},
}
# The tiles past 256 up to WIDE_FWD_MAX_HEAD_DIM. The bf16 forward there
# (mh_flash_fwd.cu::mh_fwd_wide_wgmma) gives a CTA 64 q rows and all D
# lanes and walks 32-row kv tiles (a two-stage K and V ring beside the 64 x
# D q tile fits the 227 KB a CTA may take); at PAIR_BWD_HEAD_DIMS the bf16
# fused and dkv kernels give a cluster of CTAs 64 kv rows and walk 64-row q
# tiles (the bf16 dq kernel's tiles there are KERNEL_TILES_BY_HEAD_DIM's);
# every other kernel gives a CTA one 128-lane slice of the output
# and streams the head dim of q, k, v and do in 64-column panels, on 64 q
# rows and 64 kv rows. Past
# WIDE_FWD_MAX_HEAD_DIM the bf16 forward is that slice kernel too
# (KERNEL_TILES_SLICED).
KERNEL_TILES_SLICED = {kind: {torch.bfloat16: (64, 64), torch.float32: (64, 64)}
                       for kind in ("fwd", "fused", "dkv", "dq")}
KERNEL_TILES_WIDE = {kind: dict(dtypes) for kind, dtypes in KERNEL_TILES_SLICED.items()}
KERNEL_TILES_WIDE["fwd"][torch.bfloat16] = (64, 32)
# At D = 384 and 512 the bf16 dq kernel is one CTA a 64-row q tile with
# all D lanes (mh_bwd_dq_cta), walking 32-row kv tiles at 384 and 16-row at
# 512 (Q, dO and a two-stage K and V ring fill the 227 KB a CTA may take).
KERNEL_TILES_BY_HEAD_DIM.update({
    D: {**KERNEL_TILES_WIDE, "dq": {torch.bfloat16: (64, bkv), torch.float32: (64, 64)}}
    for D, bkv in ((384, 32), (512, 16))})
WIDE_FWD_MAX_HEAD_DIM = 512
# The head dims at which the bf16 backward kernels are those of
# ops/csrc/mh_flash_bwd_pair.cuh: the fused and dkv kernels' cluster
# (mh_bwd_pair) takes lse2 and di as (B, H, T) and rotates k itself; the dq
# kernel (mh_bwd_dq_cta, one CTA a q tile) takes them as (B, T, H), k
# rotated ahead, and rotates q itself.
PAIR_BWD_HEAD_DIMS = (384, 512)
# The multiple of T every kernel takes per dtype: each bf16 CTA owns 128
# rows; the fp32 kernels take 64.
KERNEL_T_MULTIPLE = {torch.bfloat16: 128, torch.float32: 64}

# Backward routing, as the JAX package's switches of the same names: the
# fused kernel (dq, dk, dv in one pass, 5 products a tile) where one kv
# block spans the sequence / above that; False takes the split pair (dkv +
# dq kernels, 7 products a tile, no atomics: dq, dk and dv the same bits
# from run to run).
FUSED_SINGLE_KV_BWD = True
FUSED_MULTIKV_BWD = True

LN2 = 0.6931471805599453


def kernel_head_dim(head_dim: int) -> bool:
    """Whether the kernels take `head_dim` as it is: 64, 128, 256, or a
    multiple of 128 past 256."""
    D = int(head_dim)
    return D in KERNEL_HEAD_DIMS or (
        D > KERNEL_HEAD_DIMS[-1] and D % WIDE_HEAD_DIM_MULTIPLE == 0)


def padded_head_dim(head_dim: int) -> int:
    """The smallest head dim >= head_dim that the kernels take (64, 128,
    256, then the multiples of 128), whose kernels take one head of
    head_dim zero-padded."""
    D = int(head_dim)
    for d in KERNEL_HEAD_DIMS:
        if D <= d:
            return d
    return -(-D // WIDE_HEAD_DIM_MULTIPLE) * WIDE_HEAD_DIM_MULTIPLE


def kernel_tiles(kind: str, dtype: torch.dtype, head_dim: int) -> Tuple[int, int]:
    """(q tile, kv tile) of kernel `kind` ('fwd', 'fused', 'dkv', 'dq') at
    `dtype` and `head_dim`; at a head dim the kernels do not take as it is
    (one head, run zero-padded), the tiles of padded_head_dim."""
    D = padded_head_dim(head_dim)
    if D > WIDE_FWD_MAX_HEAD_DIM:
        return KERNEL_TILES_SLICED[kind][dtype]
    if D in KERNEL_TILES_BY_HEAD_DIM:
        return KERNEL_TILES_BY_HEAD_DIM[D][kind][dtype]
    if D > KERNEL_HEAD_DIMS[-1]:
        return KERNEL_TILES_WIDE[kind][dtype]
    return KERNEL_TILES[kind][dtype]


def pair_part_lanes(head_dim: int):
    """The head-dim lanes of each CTA of the bf16 fused and dkv kernels'
    cluster at head_dim in PAIR_BWD_HEAD_DIMS (a mirror of mh_bwd_pair's
    map): D // W
    parts of W lanes (W = 256 at D = 512, 128 at D = 384), part c holding
    [WQ·c, WQ·c + WQ) and D/2 + the same, WQ = W / 2. A list of int64
    tensors, part c's local lane l at entry l: lanes l and WQ + l of a part
    are rotate-half partners."""
    D = int(head_dim)
    if D not in PAIR_BWD_HEAD_DIMS:
        raise ValueError(f"head_dim {D} has no cluster kernel; one of {PAIR_BWD_HEAD_DIMS}")
    W = 256 if D == 512 else 128
    WQ = W // 2
    lo = torch.arange(WQ)
    return [torch.cat([WQ * c + lo, D // 2 + WQ * c + lo]) for c in range(D // W)]


def kernel_kv_tile(dtype: torch.dtype, head_dim: int) -> int:
    """The forward kernel's kv tile at `dtype` and `head_dim`: the block_kv
    of the plain version that rounds as the kernel does."""
    return kernel_tiles("fwd", dtype, head_dim)[1]

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Dropout stream (ops/csrc/philox.cuh)
# ---------------------------------------------------------------------------

def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m·x for a 32-bit constant m and an int64
    tensor x in [0, 2³²): torch has no uint32 multiply-high and an int64
    product of two 32-bit values overflows, so x is split in 16-bit halves
    (each partial product < 2⁴⁸)."""
    lo_p = m * (x & 0xFFFF)
    hi_p = m * (x >> 16)
    hi = (hi_p + (lo_p >> 16)) >> 16
    lo = (((hi_p & 0xFFFF) << 16) + lo_p) & _M32
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words (broadcast
    together); returns the four output words."""
    M0, M1 = 0xD2511F53, 0xCD9E8D57
    W0, W1 = 0x9E3779B9, 0xBB67AE85
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + W0) & _M32
        k1 = (k1 + W1) & _M32
    return c0, c1, c2, c3


def dropout_threshold(rate: float) -> int:
    """Keep iff bits >= this (the JAX package's `_dropout_keep`)."""
    return min(int(rate * (2.0 ** 32)), 2 ** 32 - 1)


def dropout_keep_scale(rate: float) -> float:
    """1/(1-rate) rounded to fp32, the factor of a kept value."""
    return float(np.float32(1.0 / (1.0 - rate)))


def dropout_bits(seed: int, B: int, H: int, Tq: int, j0: int, nj: int,
                 device=None) -> torch.Tensor:
    """Random words (B, H, Tq, nj) int64 of elements (b, h, i, j0 + c).

    Layout of philox.cuh: one call per 2x2 block, key = seed's two 32-bit
    halves, counter = (j >> 1, i >> 1, b·H + h, 0), word 2·(i & 1) + (j & 1).
    Tq, j0 and nj must be even."""
    if Tq % 2 or j0 % 2 or nj % 2:
        raise ValueError(f"Tq={Tq}, j0={j0}, nj={nj} must be even")
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    i2 = torch.arange(Tq // 2, device=device, dtype=torch.int64)
    j2 = torch.arange(j0 // 2, (j0 + nj) // 2, device=device, dtype=torch.int64)
    bh = torch.arange(B * H, device=device, dtype=torch.int64)
    w = philox4x32(j2[None, None, :], i2[None, :, None], bh[:, None, None],
                   torch.zeros((), dtype=torch.int64, device=device),
                   seed & _M32, seed >> 32)
    # (BH, Tq/2, nj/2, word) -> (BH, Tq/2, i&1, nj/2, j&1)
    x = torch.stack(w, dim=-1).view(B * H, Tq // 2, nj // 2, 2, 2)
    return x.permute(0, 1, 3, 2, 4).reshape(B, H, Tq, nj)


def dropout_keep(seed: int, rate: float, B: int, H: int, Tq: int, j0: int,
                 nj: int, device=None) -> torch.Tensor:
    """Keep-mask (B, H, Tq, nj) bool of key columns j0..j0+nj-1."""
    return dropout_bits(seed, B, H, Tq, j0, nj, device) >= dropout_threshold(rate)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _rope_rot(x: torch.Tensor, cosf: torch.Tensor, sinf: torch.Tensor,
              half: int) -> torch.Tensor:
    """rotate-half in fp32, written as x * [c|c] + [-x2, x1] * [s|s]
    (cosf/sinf are full-width tables broadcast against x)."""
    xf = x.float()
    swapped = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return xf * cosf + swapped * sinf


def _rope_rot_inv(x: torch.Tensor, cosf: torch.Tensor, sinf: torch.Tensor,
                  half: int) -> torch.Tensor:
    """Inverse rotation (rotate by -angle): x * [c|c] + [x2, -x1] * [s|s]."""
    xf = x.float()
    swapped = torch.cat([xf[..., half:], -xf[..., :half]], dim=-1)
    return xf * cosf + swapped * sinf


def _full_tables(rope, T: int, device):
    """(1, T, 1, D) fp32 [c|c] and [s|s] tables from the (>=T, D/2) halves."""
    cos, sin = rope
    cos2 = torch.cat([cos[:T], cos[:T]], dim=1).float().to(device)
    sin2 = torch.cat([sin[:T], sin[:T]], dim=1).float().to(device)
    return cos2[None, :, None, :], sin2[None, :, None, :]


def _mask_bias(segment_ids, s0: int, width: int, kv_segment_ids=None):
    """(B, 1, T, width) additive bias of key columns s0..s0+width-1 (their
    ids from kv_segment_ids, None: segment_ids)."""
    kv = segment_ids if kv_segment_ids is None else kv_segment_ids
    vis = segment_ids[:, :, None] == kv[:, None, s0:s0 + width]
    return torch.where(vis, 0.0, DEFAULT_MASK_VALUE)[:, None]


# ---------------------------------------------------------------------------
# Segment-skip bounds
# ---------------------------------------------------------------------------

def seg_block_bounds(a_seg: torch.Tensor, b_seg: torch.Tensor, block_a: int,
                     block_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, a-block) index range of b-blocks that may be visible:
    (lo, hi) int32 (B, Ta / block_a), inclusive, on the ids' device with no
    host sync (the JAX package's `_seg_block_bounds`).

    An (a-block, b-block) tile is fully masked whenever the blocks'
    segment-id ranges are disjoint. Packed rows carry non-decreasing ids, so
    the range test is exact there; for any id layout disjoint ranges are a
    safe sufficient condition to skip. An a-block that meets no b-block gets
    (0, 0): one masked tile, which every kernel handles."""
    B, Ta = a_seg.shape
    Tb = b_seg.shape[1]
    if Ta % block_a or Tb % block_b:
        raise ValueError(f"blocks ({block_a}, {block_b}) do not divide "
                         f"({Ta}, {Tb})")
    na, nb = Ta // block_a, Tb // block_b
    ar = a_seg.reshape(B, na, block_a).to(torch.int32)
    br = b_seg.reshape(B, nb, block_b).to(torch.int32)
    amin, amax = ar.amin(-1), ar.amax(-1)            # (B, na)
    bmin, bmax = br.amin(-1), br.amax(-1)            # (B, nb)
    inter = ((bmin[:, None, :] <= amax[:, :, None]) &
             (bmax[:, None, :] >= amin[:, :, None]))  # (B, na, nb)
    idx = torch.arange(nb, device=a_seg.device)
    lo = torch.where(inter, idx, nb).amin(-1)
    hi = torch.where(inter, idx, -1).amax(-1)
    any_ = inter.any(-1)
    lo = torch.where(any_, lo, 0).to(torch.int32).contiguous()
    hi = torch.where(any_, hi, 0).to(torch.int32).contiguous()
    return lo, hi


class SegmentBounds:
    """The skip bounds of the (B, T) q ids against the kv ids (None: q and
    kv share one array), computed at most once per tile pair and owner.
    All layers of a forward and its backward see the same ids, so the model
    makes one of these per micro-batch (the ring one per rotation) and every
    attention call reads from it."""

    def __init__(self, segment_ids: torch.Tensor,
                 kv_segment_ids: Optional[torch.Tensor] = None):
        self.segment_ids = segment_ids
        self.kv_segment_ids = (segment_ids if kv_segment_ids is None
                               else kv_segment_ids)
        self._memo: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def key(self, block_a: int, block_b: int, kv_major: bool = False) -> tuple:
        """The memo key of a tile pair and owner (kv-major is q-major when
        q and kv share their ids)."""
        kv_major = bool(kv_major) and self.kv_segment_ids is not self.segment_ids
        return (int(block_a), int(block_b)) + (("kv",) if kv_major else ())

    def get(self, block_a: int, block_b: int, kv_major: bool = False):
        """seg_block_bounds per q block of block_a rows over kv blocks of
        block_b rows; kv_major: per kv block of block_a rows over q blocks
        of block_b rows (the same thing when q and kv share their ids)."""
        key = self.key(block_a, block_b, kv_major)
        if key not in self._memo:
            a, b = self.segment_ids, self.kv_segment_ids
            self._memo[key] = seg_block_bounds(*((b, a) if len(key) > 2 else (a, b)),
                                               *key[:2])
        return self._memo[key]


def _in_range(lo, hi, nb: int):
    """(B, nA, nb) bool: b-block index within [lo, hi]."""
    idx = torch.arange(nb, device=lo.device)
    return (idx >= lo[..., None]) & (idx <= hi[..., None])


def _visit_mask(segment_ids, bounds, T: int, block_q, block_kv, owner: str,
                kv_segment_ids=None):
    """(B, T, T) bool (q row, kv column): the elements of the tiles a
    backward with these blocks visits, or None when it visits all. owner
    'q': kv range per q block (the fused multi-kv and dq kernels of the JAX
    package, the dq kernel here); 'kv': q range per kv block (the dkv
    kernels, and the fused kernel here, whose blocks own kv tiles)."""
    if segment_ids is None or block_q is None or block_kv is None:
        return None
    bq, bkv = min(int(block_q), T), min(int(block_kv), T)
    if bq == T and bkv == T:
        return None
    sb = bounds if bounds is not None else SegmentBounds(segment_ids, kv_segment_ids)
    if owner == "q":
        tiles = _in_range(*sb.get(bq, bkv), T // bkv)
    else:
        tiles = _in_range(*sb.get(bkv, bq, kv_major=True), T // bq).transpose(1, 2)
    return tiles.repeat_interleave(bq, 1).repeat_interleave(bkv, 2)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def mh_flash_forward_plain(q, k, v, segment_ids=None, rope=None, *,
                           scale: float, block_kv: Optional[int] = None,
                           dropout_rate: float = 0.0, seed: int = 0,
                           block_q: Optional[int] = None,
                           segment_skip: bool = False, bounds=None,
                           kv_segment_ids=None):
    """Plain PyTorch version of the forward kernel: (o (B,T,H,D), lse2
    (B,T,H)).

    block_kv=None takes one kv block spanning T (the JAX kernel's
    single-kv branch: P normalised against the row's final max); an
    integer walks kv blocks of that width with the online softmax (the
    multi-kv branch, and the CUDA kernel's order of rounding when it is the
    kernel's tile, `kernel_kv_tile`). The dropout mask does not depend on
    block_kv. With segment_skip (and segment ids, and more than one kv
    block) a q block of block_q rows (None: T) takes only the kv blocks
    inside its bounds; `bounds` is a SegmentBounds of the ids to read them
    from. kv_segment_ids: the kv rows' ids where they are not the q rows'
    (the ring's rotated block)."""
    B, T, H, D = q.shape
    dtype = q.dtype
    if rope is not None:
        cos2, sin2 = _full_tables(rope, T, q.device)
        q = _rope_rot(q, cos2, sin2, D // 2).to(dtype)
        k = _rope_rot(k, cos2, sin2, D // 2).to(dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    c = float(np.float32(scale * LOG2E))
    bkv = T if block_kv is None else int(block_kv)
    if T % bkv:
        raise ValueError(f"block_kv={bkv} does not divide T={T}")
    keep_scale = dropout_keep_scale(dropout_rate) if dropout_rate > 0 else 1.0
    skip = bool(segment_skip) and segment_ids is not None and bkv < T
    if skip:
        bq = T if block_q is None else int(block_q)
        sb = bounds if bounds is not None else SegmentBounds(segment_ids, kv_segment_ids)
        lo, hi = sb.get(bq, bkv)
        lo = lo.repeat_interleave(bq, 1)[:, None, :, None]   # (B, 1, T, 1)
        hi = hi.repeat_interleave(bq, 1)[:, None, :, None]

    m = torch.full((B, H, T, 1), -float("inf"), device=q.device)
    l = torch.zeros((B, H, T, 1), device=q.device)
    acc = torch.zeros((B, H, T, D), device=q.device)
    for s0 in range(0, T, bkv):
        s2 = torch.einsum("bthd,bshd->bhts", qf, kf[:, s0:s0 + bkv]) * c
        if segment_ids is not None:
            s2 = s2 + _mask_bias(segment_ids, s0, bkv, kv_segment_ids)
        m_next = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(s2 - m_next)
        l_next = alpha * l + p.sum(dim=-1, keepdim=True)
        if dropout_rate > 0.0:
            keep = dropout_keep(seed, dropout_rate, B, H, T, s0, bkv, q.device)
            p = torch.where(keep, p * keep_scale, 0.0)
        pv = torch.einsum("bhts,bshd->bhtd", p.to(dtype).float(),
                          vf[:, s0:s0 + bkv])
        if skip:
            # rows whose q block does not take this kv block keep their state
            j = s0 // bkv
            take = (lo <= j) & (j <= hi)
            m = torch.where(take, m_next, m)
            l = torch.where(take, l_next, l)
            acc = torch.where(take, acc * alpha + pv, acc)
        else:
            acc = pv if s0 == 0 else acc * alpha + pv
            m, l = m_next, l_next
    o = (acc * (1.0 / l)).to(dtype).permute(0, 2, 1, 3).contiguous()
    lse2 = (m + torch.log2(l))[..., 0].permute(0, 2, 1).contiguous()
    return o, lse2


def _backward_terms(q, k, v, do, lse2, di, segment_ids, rope, scale,
                    dropout_rate, seed, visit, kv_segment_ids=None):
    """What the three plain backwards share: the rotated q and k (fp32
    views of the rounded values), do, p_drop and ds rounded to the input
    dtype (B, H, T, T fp32), and the RoPE tables. `visit` (B, T, T) bool
    zeroes p on the tiles a skipping backward does not visit."""
    B, T, H, D = q.shape
    dtype = q.dtype
    tables = None
    if rope is not None:
        tables = _full_tables(rope, T, q.device)
        q = _rope_rot(q, *tables, D // 2).to(dtype)
        k = _rope_rot(k, *tables, D // 2).to(dtype)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    c = float(np.float32(scale * LOG2E))
    s2 = torch.einsum("bthd,bshd->bhts", qf, kf) * c
    if segment_ids is not None:
        s2 = s2 + _mask_bias(segment_ids, 0, T, kv_segment_ids)
    p = torch.exp2(s2 - lse2.permute(0, 2, 1)[..., None])
    if visit is not None:
        p = torch.where(visit[:, None], p, 0.0)
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    if dropout_rate > 0.0:
        keep_scale = dropout_keep_scale(dropout_rate)
        keep = dropout_keep(seed, dropout_rate, B, H, T, 0, T, q.device)
        p_drop = torch.where(keep, p * keep_scale, 0.0)
        dp = torch.where(keep, dp * keep_scale, 0.0)
    else:
        p_drop = p
    ds = p * (dp - di.permute(0, 2, 1)[..., None]) * scale
    return qf, kf, dof, p_drop.to(dtype).float(), ds.to(dtype).float(), tables


def _dkv_from_terms(qf, dof, p_drop, dsb, tables, dtype):
    dv = torch.einsum("bhts,bthd->bshd", p_drop, dof)
    dk = torch.einsum("bhts,bthd->bshd", dsb, qf)
    if tables is not None:
        dk = _rope_rot_inv(dk, *tables, qf.shape[-1] // 2)
    return dk.to(dtype), dv.to(dtype)


def _dq_from_terms(kf, dsb, tables, dtype):
    dq = torch.einsum("bhts,bshd->bthd", dsb, kf)
    if tables is not None:
        dq = _rope_rot_inv(dq, *tables, kf.shape[-1] // 2)
    return dq.to(dtype)


def mh_flash_backward_plain(q, k, v, do, lse2, di, segment_ids=None,
                            rope=None, *, scale: float,
                            dropout_rate: float = 0.0, seed: int = 0,
                            block_q: Optional[int] = None,
                            block_kv: Optional[int] = None,
                            segment_skip: bool = False, bounds=None,
                            kv_segment_ids=None):
    """Plain PyTorch version of the fused backward kernel (single-kv and
    multi-kv): (dq, dk, dv), each (B, T, H, D) in q's dtype. q, k pre-RoPE
    as the forward took them; do (B, T, H, D); lse2 (B, T, H) fp32 from the
    forward; di = rowsum(o·do) (B, T, H) fp32 (less any lse cotangent).
    With segment_skip and both blocks given, a kv block of block_kv rows
    takes only the q blocks inside its bounds, as the CUDA kernel does.
    kv_segment_ids: the kv rows' ids where they are not the q rows'."""
    visit = _visit_mask(segment_ids, bounds, q.shape[1], block_q, block_kv,
                        "kv", kv_segment_ids) if segment_skip else None
    qf, kf, dof, p_drop, dsb, tables = _backward_terms(
        q, k, v, do, lse2, di, segment_ids, rope, scale, dropout_rate, seed,
        visit, kv_segment_ids)
    dk, dv = _dkv_from_terms(qf, dof, p_drop, dsb, tables, q.dtype)
    return _dq_from_terms(kf, dsb, tables, q.dtype), dk, dv


def mh_flash_bwd_dkv_plain(q, k, v, do, lse2, di, segment_ids=None, rope=None,
                           *, scale: float, dropout_rate: float = 0.0,
                           seed: int = 0, block_q: Optional[int] = None,
                           block_kv: Optional[int] = None,
                           segment_skip: bool = False, bounds=None,
                           kv_segment_ids=None):
    """Plain PyTorch version of the dkv kernel of the split pair: (dk, dv).
    Arguments as mh_flash_backward_plain; a kv block takes the q blocks
    inside its bounds."""
    visit = _visit_mask(segment_ids, bounds, q.shape[1], block_q, block_kv,
                        "kv", kv_segment_ids) if segment_skip else None
    qf, _, dof, p_drop, dsb, tables = _backward_terms(
        q, k, v, do, lse2, di, segment_ids, rope, scale, dropout_rate, seed,
        visit, kv_segment_ids)
    return _dkv_from_terms(qf, dof, p_drop, dsb, tables, q.dtype)


def mh_flash_bwd_dq_plain(q, k, v, do, lse2, di, segment_ids=None, rope=None,
                          *, scale: float, dropout_rate: float = 0.0,
                          seed: int = 0, block_q: Optional[int] = None,
                          block_kv: Optional[int] = None,
                          segment_skip: bool = False, bounds=None,
                          kv_segment_ids=None):
    """Plain PyTorch version of the dq kernel of the split pair: dq.
    Arguments as mh_flash_backward_plain; a q block takes the kv blocks
    inside its bounds."""
    visit = _visit_mask(segment_ids, bounds, q.shape[1], block_q, block_kv,
                        "q", kv_segment_ids) if segment_skip else None
    _, kf, _, _, dsb, tables = _backward_terms(
        q, k, v, do, lse2, di, segment_ids, rope, scale, dropout_rate, seed,
        visit, kv_segment_ids)
    return _dq_from_terms(kf, dsb, tables, q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_qkv(names_tensors, q, kind: str):
    """q and the other (name, tensor) pairs as kernel `kind` takes them:
    a dtype and head dim it is built for, T a multiple of the dtype's
    KERNEL_T_MULTIPLE, then contiguous, aligned CUDA tensors of q's shape."""
    B, T, H, D = q.shape
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"dtype {q.dtype} not built; one of {KERNEL_DTYPES}")
    if not kernel_head_dim(D):
        raise ValueError(f"head_dim {D} not built; one of {KERNEL_HEAD_DIMS} or a "
                         f"multiple of {WIDE_HEAD_DIM_MULTIPLE} past {KERNEL_HEAD_DIMS[-1]}")
    t_multiple = KERNEL_T_MULTIPLE[q.dtype]
    if T % t_multiple or T < t_multiple:
        raise ValueError(f"T={T} must be a positive multiple of {t_multiple} "
                         f"for the {kind} kernel in {q.dtype}")
    for name, t in names_tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor (device {t.device})")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernels load 16 bytes at a time)")


def _check_rows(names_tensors, q):
    B, T, H, _ = q.shape
    for name, t in names_tensors:
        if (t.shape != (B, T, H) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous (B, T, H) float32 on "
                             f"q's device, got {tuple(t.shape)} {t.dtype}")


def _seg_ptr(segment_ids, q):
    if segment_ids is None:
        return None
    B, T = q.shape[:2]
    if (segment_ids.shape != (B, T) or segment_ids.dtype != torch.int32
            or segment_ids.device != q.device
            or not segment_ids.is_contiguous()
            or segment_ids.data_ptr() % 16):
        raise ValueError("segment_ids must be contiguous, 16-byte aligned "
                         f"(B, T) int32 on q's device, got "
                         f"{tuple(segment_ids.shape)} {segment_ids.dtype} "
                         f"on {segment_ids.device}")
    return segment_ids.data_ptr()


def _seg_ptrs(segment_ids, kv_segment_ids, q):
    """(q ids, kv ids) pointers of the kernels' C entries: both None
    (dense), or the one array's pointer twice where kv_segment_ids is None."""
    q_ptr = _seg_ptr(segment_ids, q)
    if kv_segment_ids is None:
        return q_ptr, q_ptr
    if q_ptr is None:
        raise ValueError("kv_segment_ids needs segment_ids (the q rows' ids)")
    return q_ptr, _seg_ptr(kv_segment_ids, q)


def _rope_ptrs(rope, q):
    if rope is None:
        return None, None
    T, D = q.shape[1], q.shape[3]
    cos, sin = rope[0][:T], rope[1][:T]
    for t in (cos, sin):
        if (t.shape != (T, D // 2) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError("rope tables must be contiguous, 16-byte "
                             "aligned (>=T, D/2) float32 on q's device")
    return cos.data_ptr(), sin.data_ptr()


def _bounds_ptrs(pair, q, owner_tile: int, tile_count):
    """(lo, hi, tile_count) pointers: `pair` is None (walk every tile) or
    (lo, hi) int32 (B, T / owner_tile) on q's device; tile_count is None
    or one int32 on q's device that the kernel adds its walked tiles to."""
    B, T = q.shape[:2]
    if tile_count is not None and (
            tile_count.shape != (1,) or tile_count.dtype != torch.int32
            or tile_count.device != q.device):
        raise ValueError("tile_count must be one int32 on q's device")
    tc = None if tile_count is None else tile_count.data_ptr()
    if pair is None:
        return None, None, tc
    for t in pair:
        if (t.shape != (B, T // owner_tile) or t.dtype != torch.int32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"bounds must be contiguous (B, {T // owner_tile}) "
                             f"int32 on q's device, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    return pair[0].data_ptr(), pair[1].data_ptr(), tc


def _drop_args(dropout_rate: float, seed: int):
    """(drop, thresh, keep_scale, seed) of the kernels' C entries."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout_rate {dropout_rate} not in [0, 1)")
    if dropout_rate == 0.0:
        return 0, 0, 1.0, 0
    return (1, dropout_threshold(dropout_rate),
            dropout_keep_scale(dropout_rate), int(seed) & 0xFFFFFFFFFFFFFFFF)


def _raise_on(err: int, name: str, err_string) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({err_string(err).decode()})")


def mh_flash_forward_kernel(q, k, v, segment_ids=None, rope=None, *,
                            scale: float, dropout_rate: float = 0.0,
                            seed: int = 0, kv_bounds=None, tile_count=None,
                            counter: Optional[str] = None, kv_segment_ids=None):
    """Launch the forward kernel on CUDA tensors; raises on anything it was
    not built for. kv_bounds: None or the (lo, hi) of
    seg_block_bounds(q ids, kv ids, *kernel_tiles('fwd', dtype, D)); the kv
    ids are kv_segment_ids (None: segment_ids). Adds one per
    launch to LAUNCHES[counter], by default 'mh_flash_fwd'. Under autograd,
    call it through MhFlashAttention."""
    from . import _kernels

    B, T, H, D = q.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the kernel's output carries no gradient; differentiate through "
            "flash_attention (MhFlashAttention) instead")
    _check_qkv((("q", q), ("k", k), ("v", v)), q, "fwd")
    q_seg, kv_seg = _seg_ptrs(segment_ids, kv_segment_ids, q)
    cos_ptr, sin_ptr = _rope_ptrs(rope, q)
    lo_ptr, hi_ptr, tc_ptr = _bounds_ptrs(
        kv_bounds, q, kernel_tiles("fwd", q.dtype, D)[0], tile_count)
    # scratch for k rotated once per call (every q tile reads all of it),
    # and for q where the slice kernel past 256 runs (every slice reads all
    # of it; the other kernels rotate q where they load it)
    k_rot = torch.empty_like(k) if rope is not None else None
    sliced = D > KERNEL_HEAD_DIMS[-1] and (q.dtype != torch.bfloat16
                                           or D > WIDE_FWD_MAX_HEAD_DIM)
    q_rot = torch.empty_like(q) if rope is not None and sliced else None
    drop, thresh, keep_scale, seed = _drop_args(dropout_rate, seed)

    o = torch.empty_like(q)
    lse2 = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    lib = _kernels.load_library("mh_flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.obt_mh_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg, kv_seg, cos_ptr,
            sin_ptr, None if q_rot is None else q_rot.data_ptr(),
            None if k_rot is None else k_rot.data_ptr(),
            lo_ptr, hi_ptr, tc_ptr, o.data_ptr(), lse2.data_ptr(), B, T, H, D,
            float(np.float32(scale * LOG2E)),
            1 if q.dtype == torch.bfloat16 else 0, drop, thresh, keep_scale,
            seed, stream)
    _raise_on(err, "mh_flash_fwd", lib.obt_cuda_error_string)
    _kernels.LAUNCHES[counter or "mh_flash_fwd"] += 1
    return o, lse2


# The three backward kernels, by kind (also their KERNEL_TILES row): the
# library (its C entry is obt_<library>), its error-string entry, which of
# (q tile, kv tile) a block owns, whether it takes the fp32 dq scratch of
# the fused kernel's sums, and how many outputs it writes.
_BWD_KERNELS = {
    "fused": ("mh_flash_bwd", "obt_cuda_error_string_bwd", 1, True, 3),
    "dkv": ("mh_flash_bwd_dkv", "obt_cuda_error_string_bwd_dkv", 1, False, 2),
    "dq": ("mh_flash_bwd_dq", "obt_cuda_error_string_bwd_dq", 0, False, 1),
}


def bwd_rows_by_head(kind: str, dtype: torch.dtype, head_dim: int) -> bool:
    """Whether backward kernel `kind` takes lse2 and di as (B, H, T) and
    rotates k itself: the bf16 fused kernel (also the bf16 dkv kernel) up to
    256 and at PAIR_BWD_HEAD_DIMS bulk-copy a q tile's lse2 and di of one
    head. The others take (B, T, H) and k rotated ahead."""
    return (dtype == torch.bfloat16 and kind in ("fused", "dkv")
            and (head_dim <= KERNEL_HEAD_DIMS[-1] or head_dim in PAIR_BWD_HEAD_DIMS))


def mh_flash_bwd_kernel(kind: str, q, k, v, do, lse2, di, segment_ids=None,
                        rope=None, *, scale: float, dropout_rate: float = 0.0,
                        seed: int = 0, tile_bounds=None, tile_count=None,
                        counter: Optional[str] = None, kv_segment_ids=None):
    """Launch one backward kernel on CUDA tensors; raises on anything it was
    not built for. kind 'fused': (dq, dk, dv) in one pass; 'dkv': the split
    pair's (dk, dv); 'dq': the split pair's dq. tile_bounds: None or the
    (lo, hi) of seg_block_bounds(owner's ids, walked ids, owner's tile,
    walked tile) with kernel_tiles (the fused and dkv kernels own kv tiles,
    the dq kernel q tiles); the kv ids are kv_segment_ids (None:
    segment_ids). Adds one per launch to LAUNCHES[counter], by default the
    library's name."""
    from . import _kernels

    name, err_entry, owner, dq_scratch, n_out = _BWD_KERNELS[kind]
    B, T, H, D = q.shape
    _check_qkv((("q", q), ("k", k), ("v", v), ("do", do)), q, kind)
    _check_rows((("lse2", lse2), ("di", di)), q)
    q_seg, kv_seg = _seg_ptrs(segment_ids, kv_segment_ids, q)
    cos_ptr, sin_ptr = _rope_ptrs(rope, q)
    lo_ptr, hi_ptr, tc_ptr = _bounds_ptrs(
        tile_bounds, q, kernel_tiles(kind, q.dtype, D)[owner], tile_count)
    # the slice kernels past 256 (every bf16 one but the clusters')
    sliced = D > KERNEL_HEAD_DIMS[-1] and not (q.dtype == torch.bfloat16
                                               and D in PAIR_BWD_HEAD_DIMS)
    hopper = bwd_rows_by_head(kind, q.dtype, D)
    if hopper:
        lse2, di = (t.transpose(1, 2).contiguous() for t in (lse2, di))
    # scratch: q (where the kernel re-reads it: the fused and dkv kernels,
    # and the slice kernels) and k rotated once per call, and the fused
    # kernel's fp32 dq sums
    rotated = rope is not None
    rot = [torch.empty_like(q) if rotated and (owner or sliced) else None,
           torch.empty_like(k) if rotated and not hopper else None]
    acc = ([torch.empty(q.shape, dtype=torch.float32, device=q.device)]
           if dq_scratch else [])
    drop, thresh, keep_scale, seed = _drop_args(dropout_rate, seed)

    outs = tuple(torch.empty_like(q) for _ in range(n_out))
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _kernels.load_library(name)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"obt_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), di.data_ptr(), q_seg, kv_seg, cos_ptr, sin_ptr,
            *map(ptr, rot), lo_ptr, hi_ptr, tc_ptr, *map(ptr, acc),
            *map(ptr, outs), B, T, H, D,
            float(np.float32(scale * LOG2E)), float(np.float32(scale)),
            1 if q.dtype == torch.bfloat16 else 0, drop, thresh, keep_scale,
            seed, stream)
    _raise_on(err, name, getattr(lib, err_entry))
    _kernels.LAUNCHES[counter or name] += 1
    return outs if n_out > 1 else outs[0]


def _kernel_bounds(kind: str, q, segment_ids, segment_skip: bool, bounds,
                   kv_segment_ids=None):
    """The (lo, hi) the kernel of `kind` takes at q's dtype, or None (walk
    every tile): the owner's tile first, the walked tile second."""
    if not segment_skip or segment_ids is None:
        return None
    bq, bkv = kernel_tiles(kind, q.dtype, q.shape[3])
    sb = bounds if bounds is not None else SegmentBounds(segment_ids, kv_segment_ids)
    if kind in ("fused", "dkv"):
        return sb.get(bkv, bq, kv_major=True)
    return sb.get(bq, bkv)


def mh_flash_forward(q, k, v, segment_ids=None, rope=None, *, scale: float,
                     block_kv: Optional[int] = None,
                     dropout_rate: float = 0.0, seed: int = 0,
                     block_q: Optional[int] = None,
                     segment_skip: bool = False, bounds=None,
                     counter: Optional[str] = None, kv_segment_ids=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head flash attention forward: (o (B,T,H,D), lse2 (B,T,H)).

    q, k, v: (B, T, H, D), pre-RoPE q/k; segment_ids: (B, T) int32 or None
    (dense); rope: (cos, sin) (>=T, D/2) fp32 tables or None; dropout on P
    at `dropout_rate` from the 64-bit `seed`; segment_skip prunes the tiles
    outside the segment bounds (`bounds`: a SegmentBounds of the ids to
    share them between calls). A CUDA tensor runs the CUDA kernel, which
    walks its own tiles (`kernel_tiles`) and counts the launch under
    `counter`; a CPU tensor runs the plain version with `block_q` and
    `block_kv` (None: one block). kv_segment_ids: the kv rows' ids where
    they are not the q rows'."""
    if q.is_cuda:
        return mh_flash_forward_kernel(
            q, k, v, segment_ids, rope, scale=scale,
            dropout_rate=dropout_rate, seed=seed, counter=counter,
            kv_segment_ids=kv_segment_ids,
            kv_bounds=_kernel_bounds("fwd", q, segment_ids, segment_skip, bounds,
                                     kv_segment_ids))
    return mh_flash_forward_plain(q, k, v, segment_ids, rope, scale=scale,
                                  block_kv=block_kv,
                                  dropout_rate=dropout_rate, seed=seed,
                                  block_q=block_q, segment_skip=segment_skip,
                                  bounds=bounds, kv_segment_ids=kv_segment_ids)


_BWD_PLAIN = {"fused": mh_flash_backward_plain, "dkv": mh_flash_bwd_dkv_plain,
              "dq": mh_flash_bwd_dq_plain}


def mh_flash_bwd(kind: str, q, k, v, do, lse2, di, segment_ids=None,
                 rope=None, *, scale: float, dropout_rate: float = 0.0,
                 seed: int = 0, block_q: Optional[int] = None,
                 block_kv: Optional[int] = None, segment_skip: bool = False,
                 bounds=None, counter: Optional[str] = None, kv_segment_ids=None):
    """One backward of `kind` ('fused': (dq, dk, dv); 'dkv': (dk, dv); 'dq':
    dq). A CUDA tensor runs the CUDA kernel on its own tiles (and counts the
    launch under `counter`), a CPU tensor the plain version with block_q and
    block_kv."""
    if q.is_cuda:
        return mh_flash_bwd_kernel(
            kind, q, k, v, do, lse2, di, segment_ids, rope, scale=scale,
            dropout_rate=dropout_rate, seed=seed, counter=counter,
            kv_segment_ids=kv_segment_ids,
            tile_bounds=_kernel_bounds(kind, q, segment_ids, segment_skip,
                                       bounds, kv_segment_ids))
    return _BWD_PLAIN[kind](
        q, k, v, do, lse2, di, segment_ids, rope, scale=scale,
        dropout_rate=dropout_rate, seed=seed, block_q=block_q,
        block_kv=block_kv, segment_skip=segment_skip, bounds=bounds,
        kv_segment_ids=kv_segment_ids)


# The kinds under their own names, for the kernels and the dispatchers.
mh_flash_backward_kernel = functools.partial(mh_flash_bwd_kernel, "fused")
mh_flash_bwd_dkv_kernel = functools.partial(mh_flash_bwd_kernel, "dkv")
mh_flash_bwd_dq_kernel = functools.partial(mh_flash_bwd_kernel, "dq")
mh_flash_backward = functools.partial(mh_flash_bwd, "fused")
mh_flash_bwd_dkv = functools.partial(mh_flash_bwd, "dkv")
mh_flash_bwd_dq = functools.partial(mh_flash_bwd, "dq")


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------

def _save_for_backward(ctx, q, k, v, o, lse2, segment_ids, rope_cos, rope_sin,
                       scale, dropout_rate, seed, block_q, block_kv,
                       segment_skip, bounds, multi_head=True,
                       kv_segment_ids=None):
    ctx.save_for_backward(q, k, v, o, lse2, segment_ids, rope_cos, rope_sin,
                          kv_segment_ids)
    ctx.scale, ctx.dropout_rate, ctx.seed = scale, dropout_rate, seed
    ctx.block_q, ctx.block_kv = block_q, block_kv
    ctx.segment_skip, ctx.bounds = segment_skip, bounds
    ctx.multi_head = multi_head


def _backward(ctx, do, dlse=None):
    """The JAX package's `_mh_bwd`: di = rowsum(o·do) in fp32, less the lse
    cotangent (natural-log space) where there is one, since d(lse)/ds = p
    and the kernels compute ds = p·(dp - di); then the fused kernel, or
    the split pair when the switch for the case at hand is off, and always
    for the per-head entry (multi_head=False: the JAX package's `_bwd` makes
    two calls, never a fused one), which counts them under its own names."""
    q, k, v, o, lse2, segment_ids, rope_cos, rope_sin, kv_ids = ctx.saved_tensors
    rope = None if rope_cos is None else (rope_cos, rope_sin)
    T = q.shape[1]
    do = torch.zeros_like(o) if do is None else do.contiguous()
    di = (o.float() * do.float()).sum(dim=-1)
    if dlse is not None:
        di = di - dlse.float()
    single_kv = ctx.block_kv is None or ctx.block_kv >= T
    args = (q, k, v, do, lse2, di, segment_ids, rope)
    kwargs = dict(scale=ctx.scale, dropout_rate=ctx.dropout_rate,
                  seed=ctx.seed, block_q=ctx.block_q, block_kv=ctx.block_kv,
                  segment_skip=ctx.segment_skip, bounds=ctx.bounds,
                  kv_segment_ids=kv_ids)
    if not ctx.multi_head:
        dk, dv = mh_flash_bwd_dkv(*args, **kwargs, counter="flash_bwd_dkv")
        return mh_flash_bwd_dq(*args, **kwargs, counter="flash_bwd_dq"), dk, dv
    if FUSED_SINGLE_KV_BWD if single_kv else FUSED_MULTIKV_BWD:
        # one kernel serves both fused cases; each keeps its own count
        return mh_flash_backward(
            *args, **kwargs,
            counter="mh_flash_bwd" if single_kv else "mh_flash_bwd_mk")
    dk, dv = mh_flash_bwd_dkv(*args, **kwargs)
    return mh_flash_bwd_dq(*args, **kwargs), dk, dv


class MhFlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the flash forward, and `_backward` as
    its gradient (the JAX package's `_flash_mh` custom VJP). Saves the
    pre-RoPE q, k, v, o, lse2, the segment ids and their bounds, the seed
    and the rate. block_kv_fwd is the forward's kv block, block_q and
    block_kv the backward's (and the forward's q block). multi_head=False
    is the per-head entry (`_flash`): its own launch counts, the split pair
    as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, rope_cos, rope_sin, scale,
                dropout_rate, seed, block_q, block_kv, block_kv_fwd,
                segment_skip, bounds, multi_head):
        rope = None if rope_cos is None else (rope_cos, rope_sin)
        o, lse2 = mh_flash_forward(q, k, v, segment_ids, rope, scale=scale,
                                   block_kv=block_kv_fwd,
                                   dropout_rate=dropout_rate, seed=seed,
                                   block_q=block_q, segment_skip=segment_skip,
                                   bounds=bounds,
                                   counter=None if multi_head else "flash_fwd")
        _save_for_backward(ctx, q, k, v, o, lse2, segment_ids, rope_cos,
                           rope_sin, scale, dropout_rate, seed, block_q,
                           block_kv, segment_skip, bounds, multi_head)
        return o

    @staticmethod
    def backward(ctx, do):
        return (*_backward(ctx, do), *([None] * 12))


class MhFlashAttentionLse(torch.autograd.Function):
    """(o, lse) with the natural-log logsumexp (B, T, H) as a second,
    differentiable output (the JAX package's `_flash_mh_lse`): per-block
    (o_i, lse_i) pairs recombine as o = Σ o_i·e^{lse_i} / Σ e^{lse_i}, and
    the combine's lse cotangent reaches the kernels through di. The kv rows
    may carry ids of their own (kv_segment_ids, None: the q rows')."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, kv_segment_ids, rope_cos, rope_sin,
                scale, dropout_rate, seed, block_q, block_kv, segment_skip,
                bounds):
        rope = None if rope_cos is None else (rope_cos, rope_sin)
        o, lse2 = mh_flash_forward(q, k, v, segment_ids, rope, scale=scale,
                                   block_kv=block_kv,
                                   dropout_rate=dropout_rate, seed=seed,
                                   block_q=block_q, segment_skip=segment_skip,
                                   bounds=bounds, kv_segment_ids=kv_segment_ids)
        _save_for_backward(ctx, q, k, v, o, lse2, segment_ids, rope_cos,
                           rope_sin, scale, dropout_rate, seed, block_q,
                           block_kv, segment_skip, bounds,
                           kv_segment_ids=kv_segment_ids)
        return o, lse2 * LN2

    @staticmethod
    def backward(ctx, do, dlse):
        return (*_backward(ctx, do, dlse), *([None] * 11))


def _skip_and_bounds(segment_ids, segment_skip, bounds, kv_segment_ids=None):
    skip = bool(segment_skip) and segment_ids is not None
    if skip and bounds is None:
        bounds = SegmentBounds(segment_ids, kv_segment_ids)
    return skip, bounds if skip else None


# ---------------------------------------------------------------------------
# One head at a head dim the kernels are not built for
# ---------------------------------------------------------------------------

def pad_head_dim(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(..., D) -> (..., head_dim) with each half zero-padded on its own,
    [x1, 0, x2, 0]: rotate-half pairs lane i with i + D/2, and the padded
    layout keeps each pair at i and i + head_dim/2. Zero lanes add nothing
    to any score or output, so attention on the padded q, k and v is the
    unpadded one's, in its first lanes of each half."""
    D = x.shape[-1]
    if D % 2 or head_dim < D or head_dim % 2:
        raise ValueError(f"cannot pad head_dim {D} to {head_dim}")
    pad = (0, (head_dim - D) // 2)
    half = D // 2
    return torch.cat([torch.nn.functional.pad(x[..., :half], pad),
                      torch.nn.functional.pad(x[..., half:], pad)], dim=-1)


def unpad_head_dim(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The inverse of pad_head_dim: (..., padded D) -> (..., head_dim)."""
    half, phalf = head_dim // 2, x.shape[-1] // 2
    return torch.cat([x[..., :half], x[..., phalf:phalf + half]], dim=-1)


def pad_rope(rope, head_dim: int):
    """(cos, sin) half tables (T, D/2) -> (T, head_dim/2): cos 1 and sin 0
    in the padded lanes, which then rotate zeros into zeros."""
    cos, sin = rope
    extra = head_dim // 2 - cos.shape[-1]
    return (torch.nn.functional.pad(cos, (0, extra), value=1.0).contiguous(),
            torch.nn.functional.pad(sin, (0, extra), value=0.0).contiguous())


def flash_attention_padded(q, k, v, segment_ids=None, rope=None, *,
                           head_dim: int, **kw) -> torch.Tensor:
    """flash_attention on q, k and v zero-padded to `head_dim`
    (pad_head_dim, pad_rope), its output and gradients sliced back. The
    scale is the caller's, never one of the padded width. flash_attention
    takes this route on a CUDA tensor of one head whose head dim has no
    kernel instance (the JAX dispatch's H == 1 route at any D)."""
    D = q.shape[-1]
    qp, kp, vp = (pad_head_dim(x, head_dim).contiguous() for x in (q, k, v))
    rp = None if rope is None else pad_rope((rope[0][:q.shape[1]], rope[1][:q.shape[1]]),
                                            head_dim)
    return unpad_head_dim(flash_attention(qp, kp, vp, segment_ids, rp, **kw), D)


# ---------------------------------------------------------------------------
# A sequence length that is not a multiple of the kernels' T multiple
# ---------------------------------------------------------------------------

def padded_seq_len(T: int, t_multiple: int) -> int:
    """The smallest positive multiple of t_multiple >= T."""
    return max(-(-int(T) // int(t_multiple)), 1) * int(t_multiple)


def pad_rows(x: torch.Tensor, T_pad: int) -> torch.Tensor:
    """(B, T, ...) -> (B, T_pad, ...) with zero rows appended."""
    pad = torch.zeros((x.shape[0], T_pad - x.shape[1], *x.shape[2:]),
                      dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def pad_segment_ids(segment_ids: Optional[torch.Tensor], B: int, T: int,
                    T_pad: int, device=None) -> torch.Tensor:
    """(B, T_pad) int32 ids of a call padded from T to T_pad rows, made on
    the device with no host sync. The real rows' ids are renumbered into
    [0, T): each becomes the position of its first occurrence in its row's
    sorted ids, which keeps which ids are equal and their order (so the
    skip bounds prune the same tiles); segment_ids=None gives them all 0.
    The pad rows get T, which no real row has, whatever the caller's ids
    were (negative, or the int32 extremes)."""
    if segment_ids is None:
        real = torch.zeros((B, T), dtype=torch.int32, device=device)
    else:
        ids = segment_ids.contiguous()
        real = torch.searchsorted(ids.sort(dim=1).values, ids, out_int32=True)
    pad = torch.full((B, T_pad - T), T, dtype=torch.int32, device=real.device)
    return torch.cat([real, pad], dim=1).contiguous()


def pad_rope_rows(rope, T: int, T_pad: int):
    """(cos, sin) half tables (>=T, D/2) -> (T_pad, D/2): their first T
    rows, then cos 1 and sin 0, which rotate the zero pad rows into
    zeros."""
    cos, sin = rope[0][:T], rope[1][:T]
    extra = (0, 0, 0, T_pad - T)
    return (torch.nn.functional.pad(cos, extra, value=1.0).contiguous(),
            torch.nn.functional.pad(sin, extra, value=0.0).contiguous())


def padded_block(block: Optional[int], T: int, T_pad: int) -> Optional[int]:
    """The block of a call padded from T to T_pad rows for the caller's
    `block` at T: None (one block spanning the sequence) for None or a
    block >= T, so the single-kv case stays single; else the largest
    divisor of T_pad not above it, so the multi-kv case stays multi and a
    block that divides T_pad is kept. A block < T must divide T, as the
    JAX entries assert."""
    if block is None or int(block) >= T:
        return None
    b = int(block)
    if b < 1 or T % b:
        raise ValueError(f"block {b} does not divide T={T}")
    while T_pad % b:
        b -= 1
    return b


def flash_attention_padded_t(q, k, v, segment_ids=None, rope=None, *,
                             dropout_rate: float = 0.0,
                             block_q: Optional[int] = None,
                             block_kv: Optional[int] = None,
                             block_kv_fwd: Optional[int] = None,
                             bounds=None, **kw) -> torch.Tensor:
    """flash_attention at a T that is not a multiple of
    KERNEL_T_MULTIPLE[q.dtype]: q, k and v zero-padded to the next
    multiple, the pad rows given a segment id
    no real row has (pad_segment_ids), the RoPE tables extended by cos 1
    and sin 0, the blocks carried over (padded_block); the output, and
    through autograd the gradients, sliced back to T. The mask keeps every
    real row's softmax to the real keys, the skip bounds prune the all-pad
    tiles, and the dropout stream keys each element by its (b, h, i, j)
    alone, so a padded call draws the unpadded call's mask. A `bounds` of
    the caller's ids is not used: the padded ids get their own.
    flash_attention takes this route on a CUDA tensor whose T is not such
    a multiple; on a CPU tensor it runs around the plain versions."""
    del bounds
    B, T = q.shape[:2]
    if dropout_rate > 0.0 and T % 2:
        # the dropout stream draws 2x2 blocks: the plain versions raise here
        raise ValueError(f"T={T} must be even with dropout")
    T_pad = padded_seq_len(T, KERNEL_T_MULTIPLE[q.dtype])
    qp, kp, vp = (pad_rows(x, T_pad) for x in (q, k, v))
    seg = pad_segment_ids(segment_ids, B, T, T_pad, q.device)
    rp = None if rope is None else pad_rope_rows(rope, T, T_pad)
    o = flash_attention(qp, kp, vp, seg, rp, dropout_rate=dropout_rate,
                        block_q=padded_block(block_q, T, T_pad),
                        block_kv=padded_block(block_kv, T, T_pad),
                        block_kv_fwd=padded_block(block_kv_fwd, T, T_pad), **kw)
    return o[:, :T].contiguous()


def flash_attention(q, k, v, segment_ids=None, rope=None, *, scale: float,
                    dropout_rate: float = 0.0, seed: int = 0,
                    block_kv: Optional[int] = None,
                    block_q: Optional[int] = None,
                    block_kv_fwd: Optional[int] = None,
                    segment_skip: bool = True, bounds=None,
                    multi_head: bool = True) -> torch.Tensor:
    """Differentiable multi-head flash attention: o (B, T, H, D). Without
    gradients to take it runs the forward alone.

    block_q and block_kv are the JAX package's blocks (None: the whole
    sequence) and block_kv_fwd the forward's own kv block (None: block_kv).
    They set the plain versions' tiles and whether the backward is the
    single-kv or the multi-kv case (block_kv < T); the CUDA kernels walk
    their own tiles. segment_skip (with segment ids) prunes fully masked
    tiles; `bounds`, a SegmentBounds of the ids, shares the bounds between
    calls.

    multi_head=False is the JAX package's per-head entry: it takes no rope
    (q and k arrive rotated), never skips, and its backward is always the
    split pair; its launches count as flash_fwd, flash_bwd_dkv and
    flash_bwd_dq.

    A CUDA tensor of one head at a head dim with no kernel instance runs
    the kernels of the next built head dim on zero-padded inputs
    (`flash_attention_padded`), and a CUDA tensor whose T is not a multiple
    of KERNEL_T_MULTIPLE[dtype] runs them on rows zero-padded to the next
    one (`flash_attention_padded_t`)."""
    T, H, D = q.shape[1], q.shape[2], q.shape[3]
    kw = dict(scale=scale, dropout_rate=dropout_rate, seed=seed, block_kv=block_kv,
              block_q=block_q, block_kv_fwd=block_kv_fwd,
              segment_skip=segment_skip, bounds=bounds, multi_head=multi_head)
    if q.is_cuda and H == 1 and not kernel_head_dim(D):
        return flash_attention_padded(q, k, v, segment_ids, rope,
                                      head_dim=padded_head_dim(D), **kw)
    if q.is_cuda and q.dtype in KERNEL_T_MULTIPLE and T % KERNEL_T_MULTIPLE[q.dtype]:
        return flash_attention_padded_t(q, k, v, segment_ids, rope, **kw)
    if not multi_head:
        assert rope is None, "rope fusion requires the multi_head kernel"
        segment_skip = False
    skip, bounds = _skip_and_bounds(segment_ids, segment_skip, bounds)
    if block_kv_fwd is None:
        block_kv_fwd = block_kv
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        cos, sin = (None, None) if rope is None else rope
        return MhFlashAttention.apply(q, k, v, segment_ids, cos, sin, scale,
                                      dropout_rate, seed, block_q, block_kv,
                                      block_kv_fwd, skip, bounds, multi_head)
    o, _ = mh_flash_forward(q, k, v, segment_ids, rope, scale=scale,
                            block_kv=block_kv_fwd, dropout_rate=dropout_rate,
                            seed=seed, block_q=block_q, segment_skip=skip,
                            bounds=bounds,
                            counter=None if multi_head else "flash_fwd")
    return o


def flash_attention_lse(q, k, v, segment_ids=None, rope=None, *, scale: float,
                        dropout_rate: float = 0.0, seed: int = 0,
                        block_kv: Optional[int] = None,
                        block_q: Optional[int] = None,
                        segment_skip: bool = True, bounds=None,
                        kv_segment_ids=None):
    """(o (B, T, H, D), lse (B, T, H) fp32, natural log), both
    differentiable; arguments as flash_attention. kv_segment_ids: the kv
    rows' ids (B, T), None where they are the q rows' `segment_ids`; the
    mask is q_seg[i] == kv_seg[j], and `bounds` a SegmentBounds of the
    pair."""
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError("kv_segment_ids needs segment_ids (the q rows' ids)")
    skip, bounds = _skip_and_bounds(segment_ids, segment_skip, bounds,
                                    kv_segment_ids)
    cos, sin = (None, None) if rope is None else rope
    return MhFlashAttentionLse.apply(q, k, v, segment_ids, kv_segment_ids, cos,
                                     sin, scale, dropout_rate, seed, block_q,
                                     block_kv, skip, bounds)


# Odd multiplier that mixes the model-axis index into the dropout seed: the
# JAX package's flash_attention_tp folds `idx * 0x9E3779B9` in with an xor.
TP_SEED_MIX = 0x9E3779B9


def tp_seed(seed: int, model_index: int) -> int:
    """The attention dropout seed of model-axis rank `model_index`. The
    kernels key a mask by the local head index, so the head shards need
    seeds of their own to draw independent masks."""
    return (int(seed) ^ (int(model_index) * TP_SEED_MIX)) & 0xFFFFFFFFFFFFFFFF


def flash_attention_tp(q, k, v, segment_ids=None, rope=None, *, scale: float,
                       model_index: int, dropout_rate: float = 0.0,
                       seed: int = 0, **kw) -> torch.Tensor:
    """Head-parallel flash attention (the JAX package's
    `flash_attention_tp`): q, k and v (B, T, H/M, D) hold the heads of
    model-axis rank `model_index`, and the kernels run on them with no
    communication (they take H as a run-time size). The dropout seed is
    mixed with the index (`tp_seed`); the other arguments are
    `flash_attention`'s."""
    return flash_attention(q, k, v, segment_ids, rope, scale=scale,
                           dropout_rate=dropout_rate,
                           seed=tp_seed(seed, model_index), **kw)
