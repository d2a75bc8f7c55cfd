"""Typed model configuration for the PyTorch/CUDA port.

Field for field the model configuration of `omnibiote_tpu/config.py`, so a
`meta.json` written by either package loads in the other. Fields that only
steer the JAX package's compiler (`scan_layers`, `remat_policy`,
`checkpoint_freq`, `fused_ce`) are carried for that compatibility and have
no effect on the port's inference path.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

# Token id conventions of the reference loader: SentencePiece id 1 ("<s>")
# is used as PAD and id 2 ("</s>") as MASK.
UNK_TOKEN = 0
PAD_TOKEN = 1
MASK_TOKEN = 2
EOS_TOKEN = 3

# The spurious whitespace piece ("▁") of each reference tokenizer, filtered
# at load time.
BANNED_TOKEN = {
    "mixed": 65533,
    "nucleotide": 65525,
    "peptide": 65530,
}

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string ('float32', 'bfloat16', ...)."""
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class OmniBioTAConfig:
    """Model configuration (the reference's OmniBioTAConfig plus the JAX
    package's additions: dtypes, attention implementation, µP base width)."""

    block_size: int = 2048
    vocab_size: int = 2 ** 16
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 1024
    dropout: float = 0.1
    bias: bool = False
    autoregressive: bool = False
    # Training-time rematerialisation and layer-scan switches of the JAX
    # package; carried so its meta.json loads, unused by the port.
    checkpoint_freq: int = 0
    remat_policy: str = "full"
    scan_layers: bool = False

    # 'flash' = the hand-written CUDA attention kernel (plain PyTorch on a
    # CPU tensor); 'xla' = the dense reference attention (name kept from the
    # JAX package so configs carry over unchanged).
    attn_impl: str = "flash"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    rope_theta: float = 10000.0

    # MLM-head option of the JAX package (training only).
    fused_ce: bool = False

    # True for weights whose q/k projection rows already carry the RoPE
    # de-interleave permutation (the forward then skips it).
    qkv_prepermuted: bool = False

    # 'auto' (= 'erf') | 'erf' | 'fast': exact erf-GELU with the reference's
    # 1.41421 constant, or its degree-7 polynomial fit.
    gelu: str = "auto"

    # int8 attention at inference; not yet ported (ROADMAP Queue 2, #9).
    attn_int8: bool = False

    # µP base width: width_mult = n_embd / mup_base_n_embd.
    mup_base_n_embd: int = 24
    mup_output_mult: float = 1.0

    @property
    def head_dim(self) -> int:
        if self.n_embd % self.n_head:
            raise ValueError(
                f"n_head={self.n_head} does not divide n_embd={self.n_embd}")
        return self.n_embd // self.n_head

    @property
    def width_mult(self) -> float:
        return self.n_embd / self.mup_base_n_embd

    @property
    def attn_scale(self) -> float:
        # µP 1/d attention scaling, literally 8/n_embd in the reference.
        return 8.0 / self.n_embd

    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "OmniBioTAConfig":
        return dataclasses.replace(self, **kw)


# Named model sizes of the reference. 'omnibiote-medium' carries the
# reference's default values verbatim, whose 12 heads do not divide
# n_embd=1024: head_dim rejects it, as the reference's own assert does.
PRESETS = {
    "omnibiote-small": dict(n_layer=8, n_embd=1024, n_head=8, block_size=1024),
    "omnibiote-medium": dict(n_layer=12, n_embd=1024, n_head=12, block_size=1024),
    "default": dict(),
}


def preset(name: str, **overrides) -> OmniBioTAConfig:
    kw = dict(PRESETS[name])
    kw.update(overrides)
    return OmniBioTAConfig(**kw)
