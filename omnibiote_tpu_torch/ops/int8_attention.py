"""Int8 flash attention for the serving path (encode()).

Port of `omnibiote_tpu/ops/int8_attention.py` (Pallas kernel
`_int8_fwd_kernel`): the CUDA kernel's wrapper, its plain PyTorch version
and the quantisation prologue both share. Serving only: no dropout, no
backward, no lse. Selected by OmniBioTAConfig.attn_int8
(api.Encoder(quantize=True, quantize_attention=True)).

The function, per batch row b and head h (identical in the kernel and the
plain version):
  * q and k rows in fp32, rotated by rotate-half RoPE when tables are given
    (not rounded back to the input dtype);
  * q8, sq and k8, sk: symmetric int8 per (token, head), s = max|x| · (1/127),
    0 -> 1, x8 = round(x / s), a division, round half to even;
  * s_i = q8 · k8ᵀ in int32; s2 = float(s_i) · (sq · (scale · log2 e)) · sk
    + bias, bias 0 on equal segment ids and DEFAULT_MASK_VALUE otherwise;
  * m2 = the row's max over all T keys; p = exp2(s2 - m2); l = Σ p in fp32,
    the exact normaliser, from the unquantized p; p8 = round(p · 127);
  * sv = max|v| · (1/127) per channel over all T tokens of the row's head,
    masked or not, 0 -> 1; v8 = round(v / sv);
  * o = float(p8 · v8) · (sv · (1/127)) / l, cast to q's dtype.

Why the H100 design has a prologue and two walks where the TPU's has
neither. The TPU kernel holds one kv block spanning T in VMEM and rotates
and quantizes all of K and V inside every grid step, because there a
preamble through HBM cost more than it saved. On the H100 a CTA owns a
128-row q tile of one head and has 227 KB at most, so eight q tiles of a
T = 1024 row would each redo T x D of that work: here two kernels ahead of
the attention kernel rotate and quantize q and k once a call (`quant_qk`:
q8, k8 (B, H, T, D) int8 with sq, sk (B, H, T) fp32) and, one block a
(b, h, 16 channels), reduce |v| over T per channel and then quantize v
(`quant_v`: sv (B, H, D); v8t (B, H, D, T), transposed, since 8-bit wgmma
has no transpose bit and P8 . V8 wants V8 K-major along kv). And P is quantized
against the row's final max, not a running one, so the attention kernel
cannot rescale as an online softmax does: it walks the kv tiles twice,
first for m2 alone, then for p, l, p8 and p8 · v8, whose int32 sums need no
rescaling at all. Both products are s8 wgmma from a TMA-filled ring (a
producer warpgroup and two consumers of 64 q rows in turns). A thread's
score accumulators are not the byte order its P8 register operand wants,
so v8t's kv axis is permuted inside every 32-block (`kernel_kv_order`)
and each thread packs its own p8 bytes: `int8_kernel_layout` is the
prologue's output in that order, `int8_natural_layout` undoes it. Past
D = 256 (any multiple of 128) the prologue takes a warp a (token, head)
row. Up to D = 512 the attention kernel (`int8_fwd_wide_wgmma`) gives a
CTA 64 q rows and all D channels: its two consumers split S8 by kv columns
(each over the whole head dim, so no product is done twice), store their
P8 A-fragment words into one shared-memory panel in that same order, and
split P8 . V8 by channels. Past 512 the attention kernel (`int8_fwd_wide`)
gives a CTA 128 channels of V8 and 64 q rows, summing S over the whole
head dim again in every channel slice (mma.sync s8 products): the same
integers in every slice, so the same P8 bytes, in the same layout.

The kernels take T in multiples of KERNEL_T_MULTIPLE; on a CUDA tensor at
another T `int8_flash_attention` zero-pads the rows to the next one, on a
segment id of their own (`int8_flash_attention_padded_t`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .flash_attention import (DEFAULT_MASK_VALUE, LOG2E, _full_tables,
                              _raise_on, _rope_ptrs, _rope_rot, _seg_ptr,
                              pad_rope_rows, pad_rows, pad_segment_ids,
                              padded_block, padded_seq_len)

# What the CUDA kernel is built for: instances of their own at 128, 256,
# 384 and 512 (`int8_fwd_wide_wgmma` past 256), and past 512 one set that
# takes every multiple of 128 (`int8_fwd_wide`); `kernel_head_dim` is the
# test every caller uses.
KERNEL_HEAD_DIMS = (128, 256)
KERNEL_DTYPES = (torch.float32, torch.bfloat16)
KERNEL_T_MULTIPLE = 128


def kernel_head_dim(head_dim: int) -> bool:
    """Whether the int8 kernel takes `head_dim`: every multiple of 128."""
    return int(head_dim) >= 128 and int(head_dim) % 128 == 0

_INV127 = 1.0 / 127.0


def _quant_last(xf: torch.Tensor, dim: int):
    """Symmetric int8 of fp32 `xf` with one scale along `dim`: (x8 int8,
    scale fp32 with `dim` kept)."""
    s = xf.abs().amax(dim=dim, keepdim=True) * _INV127
    s = torch.where(s == 0.0, 1.0, s)
    return torch.round(xf / s).to(torch.int8), s


def int8_quantize_plain(q, k, v, rope=None):
    """The prologue in plain PyTorch: (q8, sq, k8, sk, v8t, sv) with q8, k8
    (B, H, T, D) int8, sq, sk (B, H, T) fp32, v8t (B, H, D, T) int8 and sv
    (B, H, D) fp32, from (B, T, H, D) q, k (pre-RoPE) and v."""
    B, T, H, D = q.shape
    qf, kf = q.float(), k.float()
    if rope is not None:
        cos2, sin2 = _full_tables(rope, T, q.device)
        qf = _rope_rot(qf, cos2, sin2, D // 2)
        kf = _rope_rot(kf, cos2, sin2, D // 2)
    q8, sq = _quant_last(qf.permute(0, 2, 1, 3), 3)
    k8, sk = _quant_last(kf.permute(0, 2, 1, 3), 3)
    v8t, sv = _quant_last(v.float().permute(0, 2, 3, 1), 3)   # scale over T
    return (q8.contiguous(), sq[..., 0].contiguous(), k8.contiguous(),
            sk[..., 0].contiguous(), v8t.contiguous(), sv[..., 0].contiguous())


def kernel_kv_order(T: int, device=None) -> torch.Tensor:
    """The kernel's kv order: position j of v8t's last axis in the kernel's
    layout holds kv index order[j]. Inside each 32-block, k = 16·hf + 4·t + i
    (the byte i of a thread's A register for k-step half hf, t = lane % 4)
    holds kv 16·hf + 2·t + (i & 1) + 8·(i >> 1): the columns 8n + 2t, + 1
    of the score blocks n that thread holds."""
    if T % 32:
        raise ValueError(f"T={T} must be a multiple of 32")
    k = torch.arange(32, device=device)
    kv = (k & 16) | ((k >> 1) & 6) | (k & 1) | ((k & 2) << 2)
    return (torch.arange(0, T, 32, device=device)[:, None] + kv).reshape(T)


def int8_kernel_layout(q8, sq, k8, sk, v8t, sv):
    """The prologue's six tensors (as int8_quantize_plain gives them) in the
    kernel's layout: v8t's kv axis in `kernel_kv_order`, the rest as given.
    int8_quantize_kernel returns this."""
    order = kernel_kv_order(v8t.shape[-1], v8t.device)
    return q8, sq, k8, sk, v8t[..., order].contiguous(), sv


def int8_natural_layout(q8, sq, k8, sk, v8t, sv):
    """The inverse of int8_kernel_layout."""
    order = kernel_kv_order(v8t.shape[-1], v8t.device)
    natural = torch.empty_like(v8t)
    natural[..., order] = v8t
    return q8, sq, k8, sk, natural, sv


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of integer-valued tensors as int32, exact: an int32 product on
    the CPU; on the card, which has no integer matmul outside `_int_mm`,
    through float64, where sums below 2^53 are exact."""
    if a.is_cuda:
        return torch.matmul(a.double(), b.double()).to(torch.int32)
    return torch.matmul(a.int(), b.int())


def _check_block_q(T: int, block_q: int) -> int:
    bq = min(int(block_q), T)
    if bq < 1 or T % bq:
        raise ValueError(f"block_q={block_q} does not divide T={T}")
    return bq


def int8_flash_attention_plain(q, k, v, *, scale: float, segment_ids=None,
                               block_q: int = 512, rope=None) -> torch.Tensor:
    """Plain PyTorch version of the int8 attention kernel: o (B, T, H, D) in
    q's dtype. Products in int32 (`_int_matmul`); block_q rows of scores at a time
    (it bounds the memory, the result does not depend on it)."""
    B, T, H, D = q.shape
    bq = _check_block_q(T, block_q)
    q8, sq, k8, sk, v8t, sv = int8_quantize_plain(q, k, v, rope)
    c = float(np.float32(scale * LOG2E))
    kt, v8 = k8.transpose(2, 3), v8t.transpose(2, 3)
    out = torch.empty((B, H, T, D), dtype=q.dtype, device=q.device)
    for r0 in range(0, T, bq):
        s_i = _int_matmul(q8[:, :, r0:r0 + bq], kt)
        s2 = s_i.float() * (sq[:, :, r0:r0 + bq, None] * c) * sk[:, :, None, :]
        if segment_ids is not None:
            vis = (segment_ids[:, r0:r0 + bq, None] == segment_ids[:, None, :])
            s2 = s2 + torch.where(vis, 0.0, DEFAULT_MASK_VALUE)[:, None]
        m2 = s2.amax(dim=-1, keepdim=True)
        p = torch.exp2(s2 - m2)
        l = p.sum(dim=-1, keepdim=True)
        p8 = torch.round(p * 127.0).to(torch.int8)
        pv = _int_matmul(p8, v8)
        o = pv.float() * (sv[:, :, None, :] * _INV127) / l
        out[:, :, r0:r0 + bq] = o.to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()


def _check_inputs(q, k, v):
    B, T, H, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} is not a CUDA tensor (device {t.device})")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dtype not in KERNEL_DTYPES:
        raise ValueError(f"dtype {q.dtype} not built; one of {KERNEL_DTYPES}")
    if not kernel_head_dim(D):
        raise ValueError(f"head_dim {D} not built; the int8 kernel takes "
                         f"multiples of 128")
    if T < KERNEL_T_MULTIPLE or T % KERNEL_T_MULTIPLE:
        raise ValueError(f"T={T} must be a positive multiple of "
                         f"{KERNEL_T_MULTIPLE}")


def _launch(q, k, v, segment_ids, rope, scale: float, with_attention: bool):
    """The prologue kernels and, with_attention, the attention kernel on
    CUDA tensors: (o or None, (q8, sq, k8, sk, v8t, sv)), v8t in the
    kernel's layout (int8_kernel_layout)."""
    from . import _kernels

    _check_inputs(q, k, v)
    B, T, H, D = q.shape
    seg_ptr = _seg_ptr(segment_ids, q)
    cos_ptr, sin_ptr = _rope_ptrs(rope, q)
    dev = q.device
    q8 = torch.empty((B, H, T, D), dtype=torch.int8, device=dev)
    k8 = torch.empty((B, H, T, D), dtype=torch.int8, device=dev)
    v8t = torch.empty((B, H, D, T), dtype=torch.int8, device=dev)
    sq = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    sk = torch.empty((B, H, T), dtype=torch.float32, device=dev)
    sv = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    o = torch.empty_like(q) if with_attention else None
    lib = _kernels.load_library("int8_flash_fwd")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.obt_int8_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_ptr, cos_ptr,
            sin_ptr, q8.data_ptr(), sq.data_ptr(), k8.data_ptr(),
            sk.data_ptr(), v8t.data_ptr(), sv.data_ptr(),
            None if o is None else o.data_ptr(), B, T, H, D,
            float(np.float32(scale * LOG2E)),
            1 if q.dtype == torch.bfloat16 else 0, stream)
    _raise_on(err, "int8_flash_fwd", lib.obt_cuda_error_string_int8)
    return o, (q8, sq, k8, sk, v8t, sv)


def int8_quantize_kernel(q, k, v, rope=None):
    """The kernel's prologue alone on CUDA tensors, for checks against
    int8_kernel_layout(*int8_quantize_plain(...)): the same six tensors, v8t
    in the kernel's layout. Counts no launch."""
    return _launch(q, k, v, None, rope, 1.0, False)[1]


def int8_attention_from_quantized(quantized, *, scale: float, dtype,
                                  segment_ids=None) -> torch.Tensor:
    """The attention kernel alone on the six CUDA tensors that
    int8_quantize_kernel returned: o (B, T, H, D) in `dtype`, as
    int8_flash_attention gives it on the inputs they came from. It times
    the kernel apart from its prologue. Adds one to
    LAUNCHES['int8_flash_fwd']."""
    from . import _kernels

    q8, sq, k8, sk, v8t, sv = quantized
    B, H, T, D = q8.shape
    shapes = ((q8, (B, H, T, D), torch.int8), (k8, (B, H, T, D), torch.int8),
              (v8t, (B, H, D, T), torch.int8), (sq, (B, H, T), torch.float32),
              (sk, (B, H, T), torch.float32), (sv, (B, H, D), torch.float32))
    for t, shape, dt in shapes:
        if (not t.is_cuda or t.device != q8.device or tuple(t.shape) != shape
                or t.dtype != dt or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"want contiguous, 16-byte aligned CUDA {shape} {dt}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if dtype not in KERNEL_DTYPES:
        raise ValueError(f"dtype {dtype} not built; one of {KERNEL_DTYPES}")
    o = torch.empty((B, T, H, D), dtype=dtype, device=q8.device)
    seg_ptr = _seg_ptr(segment_ids, o)
    lib = _kernels.load_library("int8_flash_fwd")
    with torch.cuda.device(q8.device):
        err = lib.obt_int8_flash_attn(
            q8.data_ptr(), sq.data_ptr(), k8.data_ptr(), sk.data_ptr(),
            v8t.data_ptr(), sv.data_ptr(), seg_ptr, o.data_ptr(), B, T, H, D,
            float(np.float32(scale * LOG2E)),
            1 if dtype == torch.bfloat16 else 0,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "int8_flash_fwd", lib.obt_cuda_error_string_int8)
    _kernels.LAUNCHES["int8_flash_fwd"] += 1
    return o


def int8_flash_attention_kernel(q, k, v, *, scale: float, segment_ids=None,
                                block_q: int = 512, rope=None) -> torch.Tensor:
    """Launch the int8 attention kernel (ops/csrc/int8_flash_fwd.cu) on CUDA
    tensors; raises on anything it was not built for. It walks its own
    tiles, so block_q is only checked. Adds one to
    LAUNCHES['int8_flash_fwd'] per launch."""
    from . import _kernels

    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("int8 attention is serving-only: it has "
                                  "no backward")
    _check_block_q(q.shape[1], block_q)
    o, _ = _launch(q, k, v, segment_ids, rope, scale, True)
    _kernels.LAUNCHES["int8_flash_fwd"] += 1
    return o


def int8_flash_attention_padded_t(q, k, v, *, scale: float, segment_ids=None,
                                  block_q: int = 512, rope=None) -> torch.Tensor:
    """int8_flash_attention at a T that is not a multiple of
    KERNEL_T_MULTIPLE: q, k and v zero-padded to the next multiple, the
    pad rows given a segment id no real row has
    (`flash_attention.pad_segment_ids`), the RoPE tables extended by cos 1
    and sin 0; the output sliced back to T. A zero row
    quantizes to zeros with scale 1 and leaves every real row's q and k
    scales alone; v's per-channel max over T does not move for zeros; the
    mask gives the pad keys p = 0, so l, p8 and o of every real row are the
    unpadded call's. int8_flash_attention takes this route on a CUDA tensor
    whose T is not a multiple of KERNEL_T_MULTIPLE; on a CPU tensor it runs
    around the plain version. block_q must divide T as there (it only
    bounds the plain version's memory)."""
    B, T = q.shape[:2]
    bq = _check_block_q(T, block_q)
    T_pad = padded_seq_len(T, KERNEL_T_MULTIPLE)
    qp, kp, vp = (pad_rows(x, T_pad) for x in (q, k, v))
    o = int8_flash_attention(
        qp, kp, vp, scale=scale,
        segment_ids=pad_segment_ids(segment_ids, B, T, T_pad, q.device),
        block_q=padded_block(bq, T, T_pad) or T_pad,
        rope=None if rope is None else pad_rope_rows(rope, T, T_pad))
    return o[:, :T].contiguous()


def int8_flash_attention(q, k, v, *, scale: float, segment_ids=None,
                         block_q: int = 512, rope=None) -> torch.Tensor:
    """Serving-only int8 attention: o (B, T, H, D) in q's dtype.

    q, k, v: (B, T, H, D), q and k pre-rotation when rope=(cos, sin) tables
    (>=T, D/2) are given (the kernel owns RoPE); segment_ids (B, T) int32 or
    None (dense). Requires D % 128 == 0, and block_q (cut to T) dividing T,
    as the JAX entry does. A CUDA tensor runs the CUDA kernel, at a T that
    is not a multiple of KERNEL_T_MULTIPLE on zero-padded rows
    (`int8_flash_attention_padded_t`); a CPU tensor runs the plain
    version."""
    if q.is_cuda and q.shape[1] % KERNEL_T_MULTIPLE:
        return int8_flash_attention_padded_t(
            q, k, v, scale=scale, segment_ids=segment_ids, block_q=block_q,
            rope=rope)
    if q.is_cuda:
        return int8_flash_attention_kernel(
            q, k, v, scale=scale, segment_ids=segment_ids, block_q=block_q,
            rope=rope)
    return int8_flash_attention_plain(
        q, k, v, scale=scale, segment_ids=segment_ids, block_q=block_q,
        rope=rope)
