"""Multi-head flash attention: the CUDA kernels' wrappers, their plain
PyTorch versions, the dropout stream they share, and the autograd Function
that joins forward and backward.

Port of `omnibiote_tpu/ops/flash_attention.py`: the forward `_mh_fwd`
(Pallas kernel `_mh_fwd_kernel`) and the single-kv fused backward
`_mh_bwd_fused` (Pallas kernel `_mh_bwd_fused_kernel`) that `_mh_bwd` takes
at T <= 1024. Bidirectional attention over (B, T, H, D) q/k/v with
rotate-half RoPE fused in, segment-id masking, dropout on P and a
log2-space logsumexp residual. The kernels are `ops/csrc/mh_flash_fwd.cu`
and `ops/csrc/mh_flash_bwd.cu`.

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
    product operands; inverse RoPE on the fp32 dq and dk before the cast.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634

# The kernels' head dims and dtypes (one template instance each).
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# The forward kernel's kv tile per dtype (its online softmax rounds P per
# tile), and the multiple of T both kernels take.
KERNEL_KV_TILE = {torch.bfloat16: 64, torch.float32: 32}
KERNEL_T_MULTIPLE = 64

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


def _mask_bias(segment_ids, s0: int, width: int):
    """(B, 1, T, width) additive bias of key columns s0..s0+width-1."""
    vis = segment_ids[:, :, None] == segment_ids[:, None, s0:s0 + width]
    return torch.where(vis, 0.0, DEFAULT_MASK_VALUE)[:, None]


def mh_flash_forward_plain(q, k, v, segment_ids=None, rope=None, *,
                           scale: float, block_kv: Optional[int] = None,
                           dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the forward kernel: (o (B,T,H,D), lse2
    (B,T,H)).

    block_kv=None takes one kv block spanning T (the JAX kernel's
    single-kv branch: P normalised against the row's final max); an
    integer walks kv blocks of that width with the online softmax (the
    multi-kv branch, and the CUDA kernel's order of rounding when it is the
    kernel's tile, KERNEL_KV_TILE). The dropout mask does not depend on
    block_kv."""
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

    m = torch.full((B, H, T, 1), -float("inf"), device=q.device)
    l = torch.zeros((B, H, T, 1), device=q.device)
    acc = torch.zeros((B, H, T, D), device=q.device)
    for s0 in range(0, T, bkv):
        s2 = torch.einsum("bthd,bshd->bhts", qf, kf[:, s0:s0 + bkv]) * c
        if segment_ids is not None:
            s2 = s2 + _mask_bias(segment_ids, s0, bkv)
        m_next = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(s2 - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        if dropout_rate > 0.0:
            keep = dropout_keep(seed, dropout_rate, B, H, T, s0, bkv, q.device)
            p = torch.where(keep, p * keep_scale, 0.0)
        pv = torch.einsum("bhts,bshd->bhtd", p.to(dtype).float(),
                          vf[:, s0:s0 + bkv])
        acc = pv if s0 == 0 else acc * alpha + pv
        m = m_next
    o = (acc * (1.0 / l)).to(dtype).permute(0, 2, 1, 3).contiguous()
    lse2 = (m + torch.log2(l))[..., 0].permute(0, 2, 1).contiguous()
    return o, lse2


def mh_flash_backward_plain(q, k, v, do, lse2, di, segment_ids=None,
                            rope=None, *, scale: float,
                            dropout_rate: float = 0.0, seed: int = 0):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv), each
    (B, T, H, D) in q's dtype. q, k pre-RoPE as the forward took them; do
    (B, T, H, D); lse2 (B, T, H) fp32 from the forward; di = rowsum(o·do)
    (B, T, H) fp32."""
    B, T, H, D = q.shape
    dtype = q.dtype
    if rope is not None:
        cos2, sin2 = _full_tables(rope, T, q.device)
        q = _rope_rot(q, cos2, sin2, D // 2).to(dtype)
        k = _rope_rot(k, cos2, sin2, D // 2).to(dtype)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    c = float(np.float32(scale * LOG2E))
    s2 = torch.einsum("bthd,bshd->bhts", qf, kf) * c
    if segment_ids is not None:
        s2 = s2 + _mask_bias(segment_ids, 0, T)
    p = torch.exp2(s2 - lse2.permute(0, 2, 1)[..., None])
    dp = torch.einsum("bthd,bshd->bhts", dof, vf)
    if dropout_rate > 0.0:
        keep_scale = dropout_keep_scale(dropout_rate)
        keep = dropout_keep(seed, dropout_rate, B, H, T, 0, T, q.device)
        p_drop = torch.where(keep, p * keep_scale, 0.0)
        dp = torch.where(keep, dp * keep_scale, 0.0)
    else:
        p_drop = p
    dv = torch.einsum("bhts,bthd->bshd", p_drop.to(dtype).float(), dof)
    ds = p * (dp - di.permute(0, 2, 1)[..., None]) * scale
    dsb = ds.to(dtype).float()
    dk = torch.einsum("bhts,bthd->bshd", dsb, qf)
    dq = torch.einsum("bhts,bshd->bthd", dsb, kf)
    if rope is not None:
        dq = _rope_rot_inv(dq, cos2, sin2, D // 2)
        dk = _rope_rot_inv(dk, cos2, sin2, D // 2)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_qkv(names_tensors, q):
    B, T, H, D = q.shape
    for name, t in names_tensors:
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor (device {t.device})")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernels load 16 bytes at a time)")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"dtype {q.dtype} not built; one of {KERNEL_DTYPES}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not built; one of {KERNEL_HEAD_DIMS}")
    if T % KERNEL_T_MULTIPLE or T < KERNEL_T_MULTIPLE:
        raise ValueError(f"T={T} must be a positive multiple of "
                         f"{KERNEL_T_MULTIPLE}")


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
                            seed: int = 0):
    """Launch the forward kernel on CUDA tensors; raises on anything it was
    not built for. Adds one to LAUNCHES['mh_flash_fwd'] per launch. Under
    autograd, call it through MhFlashAttention."""
    from . import _kernels

    B, T, H, D = q.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the kernel's output carries no gradient; differentiate through "
            "flash_attention (MhFlashAttention) instead")
    _check_qkv((("q", q), ("k", k), ("v", v)), q)
    seg_ptr = _seg_ptr(segment_ids, q)
    cos_ptr, sin_ptr = _rope_ptrs(rope, q)
    # scratch for k rotated once per call (every q tile reads all of it)
    k_rot = torch.empty_like(k) if rope is not None else None
    drop, thresh, keep_scale, seed = _drop_args(dropout_rate, seed)

    o = torch.empty_like(q)
    lse2 = torch.empty((B, T, H), dtype=torch.float32, device=q.device)
    lib = _kernels.load_library("mh_flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.obt_mh_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, cos_ptr,
            sin_ptr, None if k_rot is None else k_rot.data_ptr(),
            o.data_ptr(), lse2.data_ptr(), B, T, H, D,
            float(np.float32(scale * LOG2E)),
            1 if q.dtype == torch.bfloat16 else 0, drop, thresh, keep_scale,
            seed, stream)
    _raise_on(err, "mh_flash_fwd", lib.obt_cuda_error_string)
    _kernels.LAUNCHES["mh_flash_fwd"] += 1
    return o, lse2


def mh_flash_backward_kernel(q, k, v, do, lse2, di, segment_ids=None,
                             rope=None, *, scale: float,
                             dropout_rate: float = 0.0, seed: int = 0):
    """Launch the backward kernel on CUDA tensors: (dq, dk, dv). Raises on
    anything it was not built for. Adds one to LAUNCHES['mh_flash_bwd'] per
    launch."""
    from . import _kernels

    B, T, H, D = q.shape
    _check_qkv((("q", q), ("k", k), ("v", v), ("do", do)), q)
    for name, t in (("lse2", lse2), ("di", di)):
        if (t.shape != (B, T, H) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous (B, T, H) float32 on "
                             f"q's device, got {tuple(t.shape)} {t.dtype}")
    seg_ptr = _seg_ptr(segment_ids, q)
    cos_ptr, sin_ptr = _rope_ptrs(rope, q)
    q_rot = torch.empty_like(q) if rope is not None else None
    k_rot = torch.empty_like(k) if rope is not None else None
    dq_acc = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    drop, thresh, keep_scale, seed = _drop_args(dropout_rate, seed)

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lib = _kernels.load_library("mh_flash_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.obt_mh_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse2.data_ptr(), di.data_ptr(), seg_ptr, cos_ptr, sin_ptr,
            None if q_rot is None else q_rot.data_ptr(),
            None if k_rot is None else k_rot.data_ptr(), dq_acc.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, T, H, D,
            float(np.float32(scale * LOG2E)), float(np.float32(scale)),
            1 if q.dtype == torch.bfloat16 else 0, drop, thresh, keep_scale,
            seed, stream)
    _raise_on(err, "mh_flash_bwd", lib.obt_cuda_error_string_bwd)
    _kernels.LAUNCHES["mh_flash_bwd"] += 1
    return dq, dk, dv


def mh_flash_forward(q, k, v, segment_ids=None, rope=None, *, scale: float,
                     block_kv: Optional[int] = None,
                     dropout_rate: float = 0.0, seed: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head flash attention forward: (o (B,T,H,D), lse2 (B,T,H)).

    q, k, v: (B, T, H, D), pre-RoPE q/k; segment_ids: (B, T) int32 or None
    (dense); rope: (cos, sin) (>=T, D/2) fp32 tables or None; dropout on P
    at `dropout_rate` from the 64-bit `seed`. A CUDA tensor runs the CUDA
    kernel (which walks KERNEL_KV_TILE-wide kv tiles); a CPU tensor runs the
    plain version with `block_kv` (None: one block)."""
    if q.is_cuda:
        return mh_flash_forward_kernel(q, k, v, segment_ids, rope, scale=scale,
                                       dropout_rate=dropout_rate, seed=seed)
    return mh_flash_forward_plain(q, k, v, segment_ids, rope, scale=scale,
                                  block_kv=block_kv,
                                  dropout_rate=dropout_rate, seed=seed)


def mh_flash_backward(q, k, v, do, lse2, di, segment_ids=None, rope=None, *,
                      scale: float, dropout_rate: float = 0.0, seed: int = 0):
    """Multi-head flash attention backward: (dq, dk, dv). A CUDA tensor runs
    the CUDA kernel, a CPU tensor the plain version."""
    fn = mh_flash_backward_kernel if q.is_cuda else mh_flash_backward_plain
    return fn(q, k, v, do, lse2, di, segment_ids, rope, scale=scale,
              dropout_rate=dropout_rate, seed=seed)


class MhFlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) with the flash forward, and the fused backward
    as its gradient (the JAX package's `_flash_mh` custom VJP). Saves the
    pre-RoPE q, k, v, o, lse2, the segment ids, the seed and the rate; the
    backward computes di = rowsum(o·do) in fp32 and runs the backward
    kernel (or its plain version on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, rope_cos, rope_sin, scale,
                dropout_rate, seed, block_kv):
        rope = None if rope_cos is None else (rope_cos, rope_sin)
        o, lse2 = mh_flash_forward(q, k, v, segment_ids, rope, scale=scale,
                                   block_kv=block_kv,
                                   dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(q, k, v, o, lse2, segment_ids, rope_cos, rope_sin)
        ctx.scale, ctx.dropout_rate, ctx.seed = scale, dropout_rate, seed
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse2, segment_ids, rope_cos, rope_sin = ctx.saved_tensors
        rope = None if rope_cos is None else (rope_cos, rope_sin)
        di = (o.float() * do.float()).sum(dim=-1)
        dq, dk, dv = mh_flash_backward(
            q, k, v, do.contiguous(), lse2, di, segment_ids, rope,
            scale=ctx.scale, dropout_rate=ctx.dropout_rate, seed=ctx.seed)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash_attention(q, k, v, segment_ids=None, rope=None, *, scale: float,
                    dropout_rate: float = 0.0, seed: int = 0,
                    block_kv: Optional[int] = None) -> torch.Tensor:
    """Differentiable multi-head flash attention: o (B, T, H, D). Without
    gradients to take it runs the forward alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        cos, sin = (None, None) if rope is None else rope
        return MhFlashAttention.apply(q, k, v, segment_ids, cos, sin, scale,
                                      dropout_rate, seed, block_kv)
    o, _ = mh_flash_forward(q, k, v, segment_ids, rope, scale=scale,
                            block_kv=block_kv, dropout_rate=dropout_rate,
                            seed=seed)
    return o
