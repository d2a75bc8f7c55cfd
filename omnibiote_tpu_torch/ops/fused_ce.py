"""Vocab-chunked fused cross-entropy with its own backward.

Port of `omnibiote_tpu/ops/fused_ce.py`. The MLM head at vocab 65536 is
the largest activation of a training step: a plain `log_softmax(x @ Wᵀ)`
keeps the (N, V) logits in fp32 for its value, its residual and its
gradient. Here:

  * forward: a loop over V/n_chunks rows of W, keeping the online softmax
    statistics (running max, sum-exp) and the label's logit. Peak live
    logits: (N, V/n_chunks) fp32; only `lse` (N,) is saved;
  * backward: each chunk's logits recomputed from (x, W, lse), p =
    exp(logit - lse), the label's one subtracted, dx and the chunk's rows
    of dW accumulated. The recompute costs one more (N, D) x (D, V)
    product.

W is in the port's (V, D) layout (`lm_head.weight`), so a chunk is a
contiguous block of rows. The products are plain `torch.mm` (the JAX
function computes them outside any Pallas kernel). As in JAX, logits and
dW are fp32 products of operands in x's dtype: on a GPU a bf16 product
writes fp32 (`torch.mm(..., out_dtype=torch.float32)`); the CPU has no
such kernel and computes in the operands' dtype (fp32 in the tests).
"""
from __future__ import annotations

import torch


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with an fp32 result: fp32 accumulation and output from bf16
    operands on a GPU (the JAX chunks' preferred_element_type=float32)."""
    if a.dtype == torch.float32 or a.device.type == "cpu":
        return torch.mm(a, b).float()
    return torch.mm(a, b, out_dtype=torch.float32)


def _chunk_logits(x2, W, c: int, Vc: int):
    """(N, Vc) fp32 logits of vocab rows c·Vc .. (c+1)·Vc, and that block
    of W in x's dtype."""
    Wc = W[c * Vc:(c + 1) * Vc].to(x2.dtype)
    return _mm_f32(x2, Wc.t()), Wc


def _label_in_chunk(labels, c: int, Vc: int):
    """(local index clamped into the chunk, whether the label lies in it)."""
    loc = labels - c * Vc
    return loc.clamp(0, Vc - 1), (loc >= 0) & (loc < Vc)


class FusedCrossEntropy(torch.autograd.Function):
    """nll (N,) = -log softmax(x @ Wᵀ)[labels] for x (N, D), W (V, D) and
    labels (N,) int64, over n_chunks blocks of W's rows."""

    @staticmethod
    def forward(ctx, x, W, labels, n_chunks: int):
        Vc = W.shape[0] // n_chunks
        N = x.shape[0]
        m = torch.full((N,), -float("inf"), dtype=torch.float32, device=x.device)
        s = torch.zeros((N,), dtype=torch.float32, device=x.device)
        lab = torch.zeros((N,), dtype=torch.float32, device=x.device)
        for c in range(n_chunks):
            logits, _ = _chunk_logits(x, W, c, Vc)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            m = m_new
            loc, in_chunk = _label_in_chunk(labels, c, Vc)
            ll = logits.gather(1, loc[:, None])[:, 0]
            lab = torch.where(in_chunk, ll, lab)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, W, labels, lse)
        ctx.n_chunks = n_chunks
        return lse - lab

    @staticmethod
    def backward(ctx, g):
        x, W, labels, lse = ctx.saved_tensors
        n_chunks = ctx.n_chunks
        Vc = W.shape[0] // n_chunks
        g = g.float()
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dWs = []
        for c in range(n_chunks):
            logits, Wc = _chunk_logits(x, W, c, Vc)
            p = torch.exp(logits - lse[:, None])           # softmax chunk, fp32
            loc, in_chunk = _label_in_chunk(labels, c, Vc)
            p.scatter_add_(1, loc[:, None], -in_chunk.float()[:, None])
            pg = (p * g[:, None]).to(x.dtype)
            dWs.append(_mm_f32(pg.t(), x))                 # (Vc, D)
            dx += _mm_f32(pg, Wc)
        dW = torch.cat(dWs).to(W.dtype)
        return dx.to(x.dtype), dW, None, None


def fused_cross_entropy(x, W, labels, n_chunks: int):
    """Per-row -log softmax(x @ Wᵀ)[labels]; x (..., D), W (V, D), labels
    (...) integer. n_chunks must divide V."""
    assert W.shape[0] % n_chunks == 0, (
        f"n_chunks={n_chunks} must divide V={W.shape[0]}: a remainder "
        "would silently drop the vocab tail from the lse (wrong loss)")
    lead = x.shape[:-1]
    nll = FusedCrossEntropy.apply(x.reshape(-1, x.shape[-1]), W,
                                  labels.reshape(-1).long(), n_chunks)
    return nll.reshape(lead)


def pick_chunks(vocab_size: int, target: int = 8192) -> int:
    """Largest chunk count giving chunks of ~target; 1 (single pass) for
    small vocabularies where chunking has nothing to save."""
    if vocab_size < 2 * target:
        return 1
    n = vocab_size // target
    while vocab_size % n:
        n -= 1
    return max(n, 1)
