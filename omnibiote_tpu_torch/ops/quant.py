"""Int8 quantized inference for the serving path (encode()).

Port of `omnibiote_tpu/ops/quant.py`. Scheme:

  * weights: symmetric per-output-channel int8 (scale = max|w_channel| /
    127), quantized once by quantize_for_inference();
  * activations: symmetric per-row dynamic int8 (scale = max|x_row| / 127),
    quantized on the fly in fp32 before each product;
  * accumulation in int32, rescaled by the outer product of the two scales.

Layout. The port keeps torch's (out, in) weight layout: `values` is
(fan_out, fan_in) int8, the transpose of the JAX package's (fan_in, fan_out),
and `scale` is (fan_out,) fp32, one per output channel (row of `values`) in
both. The RoPE de-interleave permutation of the q and k output channels
(models/omnibiota.py::Block) is folded into the quantized c_attn at
conversion time and `cfg.qkv_prepermuted=True` skips the per-forward gather.

The int8 x int8 -> int32 product is a plain matrix product outside any
kernel, as in the JAX package: `torch._int_mm` (cuBLASLt) on a CUDA tensor,
an int32 matmul on a CPU tensor; both are exact. The quantise and rescale
passes are plain PyTorch. Training stays bf16/fp32: this is an
inference-only artifact.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import torch
from torch import nn


class QuantizedWeight(NamedTuple):
    """Per-output-channel symmetric int8 weight: w ~ values * scale[:, None]."""
    values: torch.Tensor         # int8, (fan_out, fan_in)
    scale: torch.Tensor          # fp32, (fan_out,)


def quantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """w: (fan_out, fan_in). scale = max|w| over fan_in / 127 (0 -> 1),
    values = clip(round(w / scale), ±127), round half to even."""
    wf = w.float()
    scale = wf.abs().amax(dim=1) / 127.0
    scale = torch.where(scale == 0.0, 1.0, scale)
    q = torch.round(wf / scale[:, None]).clamp(-127, 127).to(torch.int8)
    return QuantizedWeight(q.contiguous(), scale)


def _int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (N, K) int8 transposed -> (M, N) int32, exact."""
    if not x_q.is_cuda:
        return x_q.int() @ w_q.int().t()
    M = x_q.shape[0]
    # cuBLASLt's int8 product wants more than 16 rows: pad with zeros
    if M <= 16:
        x_q = torch.cat([x_q, x_q.new_zeros(32 - M, x_q.shape[1])])
    # (N, K) contiguous seen as (K, N) column-major: the layout it takes
    return torch._int_mm(x_q, w_q.t())[:M]


def quantize_rows(x: torch.Tensor):
    """The quantise pass of quant_linear: (M, K) activations -> (x_q int8
    (M, K), s_x fp32 (M, 1)), s_x = max|x_row| / 127 (0 -> 1), x_q =
    clip(round(x / s_x), ±127) in fp32, round half to even."""
    xf = x.float()
    s_x = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    s_x = torch.where(s_x == 0.0, 1.0, s_x)
    return torch.round(xf / s_x).clamp(-127, 127).to(torch.int8), s_x


def rescale(acc: torch.Tensor, s_x: torch.Tensor, w_scale: torch.Tensor,
            b: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The rescale pass of quant_linear: int32 sums (M, N) times s_x *
    w_scale (in that association), the bias added in fp32, cast to dtype."""
    y = acc.float() * (s_x * w_scale[None, :])
    if b is not None:
        y = y + b.float()
    return y.to(dtype)


def quant_linear(x: torch.Tensor, w: QuantizedWeight,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ dequant(w)ᵀ computed as int8 x int8 -> int32 with dynamic
    per-row activation scales: quantize_rows, the int8 product, rescale.
    x: (..., fan_in); returns x.dtype."""
    shape = x.shape
    x_q, s_x = quantize_rows(x.reshape(-1, shape[-1]))
    y = rescale(_int8_matmul(x_q, w.values), s_x, w.scale, b, x.dtype)
    return y.reshape(*shape[:-1], w.values.shape[0])


class QuantizedLinear(nn.Module):
    """A Linear whose weight is a QuantizedWeight held as buffers (`values`
    int8 (fan_out, fan_in), `scale` fp32 (fan_out,)); `weight` returns the
    pair, which models/omnibiota.py::_linear dispatches on. The bias, where
    there is one, stays as it was."""

    def __init__(self, qw: QuantizedWeight, bias: Optional[torch.Tensor]):
        super().__init__()
        self.register_buffer("values", qw.values)
        self.register_buffer("scale", qw.scale)
        self.bias = None if bias is None else nn.Parameter(
            bias.detach(), requires_grad=False)

    @property
    def weight(self) -> QuantizedWeight:
        return QuantizedWeight(self.values, self.scale)


QUANTIZED_LINEARS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")


@torch.no_grad()
def quantize_for_inference(model):
    """A copy of the OmniBioTA `model` for int8 serving: every projection
    (c_attn, both c_proj, c_fc of each block, and lm_head) becomes a
    QuantizedLinear, quantized per layer, with the RoPE de-interleave
    permutation folded into c_attn's q and k output channels (weight rows
    and bias) first; its cfg has qkv_prepermuted=True. The embedding (a
    gather, not a product), the norms and the biases stay as they are, and
    the fp32 projection weights are not kept. The model given is left
    untouched."""
    if model.cfg.qkv_prepermuted:
        raise ValueError("the model's c_attn is already permuted "
                         "(cfg.qkv_prepermuted); quantize the original")
    out = copy.deepcopy(model)
    perm = out.qkv_perm
    for blk in out.transformer.h:
        c_attn = blk.attn.c_attn
        c_attn.weight.copy_(c_attn.weight[perm])
        if c_attn.bias is not None:
            c_attn.bias.copy_(c_attn.bias[perm])
        for name in QUANTIZED_LINEARS:
            parent, leaf = name.split(".")
            lin = getattr(getattr(blk, parent), leaf)
            setattr(getattr(blk, parent), leaf,
                    QuantizedLinear(quantize_weight(lin.weight), lin.bias))
    out.lm_head = QuantizedLinear(quantize_weight(out.lm_head.weight), None)
    out.cfg = out.cfg.replace(qkv_prepermuted=True)
    return out
