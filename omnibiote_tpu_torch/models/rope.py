"""Rotary position embeddings (real-valued formulation).

Numerically the reference's complex-pair RoPE: adjacent feature pairs
(x[..., 2j], x[..., 2j+1]) rotate by angle t * theta^(-2j/d), computed in
float32 and cast back to the input dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _rope_tables_np(head_dim: int, end: int, theta: float):
    freqs = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    t = np.arange(end, dtype=np.float32)
    angles = np.outer(t, freqs).astype(np.float32)  # (end, head_dim//2)
    cos, sin = np.cos(angles), np.sin(angles)
    cos.setflags(write=False)
    sin.setflags(write=False)
    return cos, sin


def rope_tables(head_dim: int, end: int, theta: float = 10000.0,
                device=None):
    """cos/sin tables of shape (end, head_dim//2), float32, on `device`."""
    cos, sin = _rope_tables_np(int(head_dim), int(end), float(theta))
    return (torch.tensor(cos, device=device), torch.tensor(sin, device=device))


def deinterleave_perm(head_dim: int) -> np.ndarray:
    """Permutation from the interleaved pair layout to the rotate-half
    layout [evens | odds]. Applied to both q and k it leaves q·kᵀ, and so
    attention, exactly invariant."""
    return np.concatenate([np.arange(0, head_dim, 2),
                           np.arange(1, head_dim, 2)])


def qkv_col_perm(n_head: int, head_dim: int) -> np.ndarray:
    """deinterleave_perm over every head's block of a fused q (or k)
    projection of width n_head * head_dim."""
    perm = deinterleave_perm(head_dim)
    return (np.arange(n_head)[:, None] * head_dim + perm[None, :]).reshape(-1)


def apply_rope_half(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                    sin: torch.Tensor):
    """Rotate-half RoPE on (B, T, H, Dh) whose head_dim is already in
    de-interleaved [evens | odds] order; equal to apply_rope up to that
    permutation."""
    T = q.shape[1]
    half = q.shape[-1] // 2
    cos = cos[:T][None, :, None, :]
    sin = sin[:T][None, :, None, :]

    def rot(x):
        xf = x.float()
        x1, x2 = xf[..., :half], xf[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                         -1).to(x.dtype)

    return rot(q), rot(k)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor):
    """Rotate q, k of shape (B, T, H, Dh) by per-position angles in the
    interleaved pair layout; fp32 arithmetic, result in the input dtype."""
    T = q.shape[1]
    cos = cos[:T][None, :, None, :]
    sin = sin[:T][None, :, None, :]

    def rot(x):
        xf = x.float()
        x_even = xf[..., 0::2]
        x_odd = xf[..., 1::2]
        out_even = x_even * cos - x_odd * sin
        out_odd = x_even * sin + x_odd * cos
        out = torch.stack([out_even, out_odd], dim=-1).reshape(x.shape)
        return out.to(x.dtype)

    return rot(q), rot(k)
