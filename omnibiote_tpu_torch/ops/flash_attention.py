"""Multi-head flash attention forward: the CUDA kernel's wrapper and its
plain PyTorch version.

Port of `omnibiote_tpu/ops/flash_attention.py::_mh_fwd` (the Pallas kernel
`_mh_fwd_kernel`) without dropout: bidirectional attention over
(B, T, H, D) q/k/v with rotate-half RoPE fused in, segment-id masking and a
log2-space logsumexp residual. The kernel itself is
`ops/csrc/mh_flash_fwd.cu`.

Numerics (identical in the kernel and the plain version):
  * RoPE rotates q and k in fp32 from the cos/sin tables, and the result is
    rounded to the input dtype before the product;
  * scores in fp32, s2 = (q·kᵀ)·(scale·log2e) + bias, with bias 0 on equal
    segment ids and DEFAULT_MASK_VALUE (finite, -0.7·f32max) otherwise, so a
    fully masked row attends uniformly (the mean of V) instead of NaN;
  * exp2-based softmax; P is rounded to the input dtype before P·V, the
    product accumulates in fp32, and o = acc · (1/l) in the input dtype;
  * lse2 = m + log2(l), (B, T, H) fp32, for the backward of the training
    slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

DEFAULT_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)
LOG2E = 1.4426950408889634

# The kernel's head dims and dtypes (one template instance each).
KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
# The kernel's kv tile per dtype (its online softmax rounds P per tile),
# and the multiple of T it takes.
KERNEL_KV_TILE = {torch.bfloat16: 64, torch.float32: 32}
KERNEL_T_MULTIPLE = 64


def _rope_rot(x: torch.Tensor, cosf: torch.Tensor, sinf: torch.Tensor,
              half: int) -> torch.Tensor:
    """rotate-half in fp32, written as x * [c|c] + [-x2, x1] * [s|s]
    (cosf/sinf are full-width tables broadcast against x)."""
    xf = x.float()
    swapped = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return xf * cosf + swapped * sinf


def _full_tables(rope, T: int):
    """(T, D) fp32 [c|c] and [s|s] tables from the (>=T, D/2) halves."""
    cos, sin = rope
    cos2 = torch.cat([cos[:T], cos[:T]], dim=1).float()
    sin2 = torch.cat([sin[:T], sin[:T]], dim=1).float()
    return cos2, sin2


def mh_flash_forward_plain(q, k, v, segment_ids=None, rope=None, *,
                           scale: float, block_kv: Optional[int] = None):
    """Plain PyTorch version of the kernel: (o (B,T,H,D), lse2 (B,T,H)).

    block_kv=None takes one kv block spanning T (the JAX kernel's
    single-kv branch: P normalised against the row's final max); an
    integer walks kv blocks of that width with the online softmax (the
    multi-kv branch, and the CUDA kernel's order of rounding when it is the
    kernel's tile, KERNEL_KV_TILE)."""
    B, T, H, D = q.shape
    dtype = q.dtype
    if rope is not None:
        cos2, sin2 = _full_tables(rope, T)
        cos2 = cos2.to(q.device)[None, :, None, :]
        sin2 = sin2.to(q.device)[None, :, None, :]
        q = _rope_rot(q, cos2, sin2, D // 2).to(dtype)
        k = _rope_rot(k, cos2, sin2, D // 2).to(dtype)
    qf, kf, vf = q.float(), k.float(), v.float()
    c = float(np.float32(scale * LOG2E))
    bkv = T if block_kv is None else int(block_kv)
    if T % bkv:
        raise ValueError(f"block_kv={bkv} does not divide T={T}")

    m = torch.full((B, H, T, 1), -float("inf"), device=q.device)
    l = torch.zeros((B, H, T, 1), device=q.device)
    acc = torch.zeros((B, H, T, D), device=q.device)
    for s0 in range(0, T, bkv):
        s2 = torch.einsum("bthd,bshd->bhts", qf, kf[:, s0:s0 + bkv]) * c
        if segment_ids is not None:
            vis = segment_ids[:, :, None] == segment_ids[:, None, s0:s0 + bkv]
            s2 = s2 + torch.where(vis, 0.0, DEFAULT_MASK_VALUE)[:, None]
        m_next = torch.maximum(m, s2.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_next)
        p = torch.exp2(s2 - m_next)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhts,bshd->bhtd", p.to(dtype).float(),
                          vf[:, s0:s0 + bkv])
        acc = pv if s0 == 0 else acc * alpha + pv
        m = m_next
    o = (acc * (1.0 / l)).to(dtype).permute(0, 2, 1, 3).contiguous()
    lse2 = (m + torch.log2(l))[..., 0].permute(0, 2, 1).contiguous()
    return o, lse2


def mh_flash_forward_kernel(q, k, v, segment_ids=None, rope=None, *,
                            scale: float):
    """Launch the CUDA kernel on CUDA tensors; raises on anything it was
    not built for. Adds one to LAUNCHES['mh_flash_fwd'] per launch."""
    from . import _kernels

    B, T, H, D = q.shape
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "the kernel has no backward yet (ROADMAP Queue 2, #2 and #3); "
            "run it under torch.no_grad() or torch.inference_mode()")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor (device {t.device})")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             "(the kernel loads 16 bytes at a time)")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"dtype {q.dtype} not built; one of {KERNEL_DTYPES}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not built; one of {KERNEL_HEAD_DIMS}")
    if T % KERNEL_T_MULTIPLE:
        raise ValueError(f"T={T} must be a multiple of {KERNEL_T_MULTIPLE}")
    seg_ptr = None
    if segment_ids is not None:
        if (segment_ids.shape != (B, T) or segment_ids.dtype != torch.int32
                or segment_ids.device != q.device
                or not segment_ids.is_contiguous()
                or segment_ids.data_ptr() % 16):
            raise ValueError("segment_ids must be contiguous, 16-byte aligned "
                             f"(B, T) int32 on q's device, got "
                             f"{tuple(segment_ids.shape)} {segment_ids.dtype} "
                             f"on {segment_ids.device}")
        seg_ptr = segment_ids.data_ptr()
    cos_ptr = sin_ptr = k_rot = None
    if rope is not None:
        cos, sin = rope[0][:T], rope[1][:T]
        for t in (cos, sin):
            if (t.shape != (T, D // 2) or t.dtype != torch.float32
                    or t.device != q.device or not t.is_contiguous()
                    or t.data_ptr() % 16):
                raise ValueError("rope tables must be contiguous, 16-byte "
                                 "aligned (>=T, D/2) float32 on q's device")
        cos_ptr, sin_ptr = cos.data_ptr(), sin.data_ptr()
        # scratch for k rotated once per call (every q tile reads all of it)
        k_rot = torch.empty_like(k)

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
            1 if q.dtype == torch.bfloat16 else 0, stream)
    if err != 0:
        raise RuntimeError(f"mh_flash_fwd launch failed: CUDA error {err} "
                           f"({lib.obt_cuda_error_string(err).decode()})")
    _kernels.LAUNCHES["mh_flash_fwd"] += 1
    return o, lse2


def mh_flash_forward(q, k, v, segment_ids=None, rope=None, *, scale: float,
                     block_kv: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-head flash attention forward: (o (B,T,H,D), lse2 (B,T,H)).

    q, k, v: (B, T, H, D), pre-RoPE q/k; segment_ids: (B, T) int32 or None
    (dense); rope: (cos, sin) (>=T, D/2) fp32 tables or None. A CUDA
    tensor runs the CUDA kernel (which walks KERNEL_KV_TILE-wide kv tiles);
    a CPU tensor runs the plain version with `block_kv` (None: one block)."""
    if q.is_cuda:
        return mh_flash_forward_kernel(q, k, v, segment_ids, rope, scale=scale)
    return mh_flash_forward_plain(q, k, v, segment_ids, rope, scale=scale,
                                  block_kv=block_kv)
