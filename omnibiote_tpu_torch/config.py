"""Typed model configuration for the PyTorch/CUDA port.

Field for field the model configuration of `omnibiote_tpu/config.py`, so a
`meta.json` written by either package loads in the other. `scan_layers`
only steers the JAX package's compiler and is carried for that
compatibility; `checkpoint_freq`, `remat_policy` and `fused_ce` select the
port's rematerialisation and fused cross-entropy as they select the JAX
package's.
`TrainConfig` is the JAX package's pretraining configuration field for
field, including its TPU-mesh fields, so a checkpoint's meta.json carries
over both ways.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

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
    # Activation rematerialisation: 0 = none; k > 0 remats every block, as
    # the JAX package does under lax.scan (the reference checkpoints every
    # k-th block). remat_policy 'full' recomputes the whole block; 'dots'
    # keeps the projections' outputs and recomputes the rest.
    checkpoint_freq: int = 0
    remat_policy: str = "full"
    # The JAX package's layer-scan switch; carried so its meta.json loads.
    scan_layers: bool = False

    # 'flash' = the hand-written CUDA attention kernel (plain PyTorch on a
    # CPU tensor); 'xla' = the dense reference attention (name kept from the
    # JAX package so configs carry over unchanged).
    attn_impl: str = "flash"
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    rope_theta: float = 10000.0

    # MLM head: the vocab-chunked fused cross-entropy (ops/fused_ce.py)
    # instead of the plain log_softmax (training only).
    fused_ce: bool = False

    # True for weights whose q/k projection rows already carry the RoPE
    # de-interleave permutation (the forward then skips it).
    qkv_prepermuted: bool = False

    # 'auto' (= 'erf') | 'erf' | 'fast': exact erf-GELU with the reference's
    # 1.41421 constant, or its degree-7 polynomial fit.
    gelu: str = "auto"

    # int8 attention at inference (ops/int8_attention.py), set by
    # api.Encoder(quantize=True, quantize_attention=True).
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


@dataclass(frozen=True)
class TrainConfig:
    """Pretraining configuration (the reference CLI's flags,
    train_encoder.py:438-466, plus the JAX package's additions).

    The mesh fields are the JAX package's (`omnibiote_tpu/config.py`):
    `sharding` 'replicated' (DDP), 'fsdp', 'tp' or 'fsdp+tp' over a mesh
    of `mesh_shape` ('data'[, 'model']; None: every rank on 'data'), 'sp'
    over ('seq',) or ('data', 'seq'), or the pipeline, 'pp' over
    ('stage',) or ('data', 'stage') and 'fsdp+pp' over ('data', 'stage'),
    run by the Trainer over torch.distributed (parallel/).
    `dp_axis`, `rng_impl` and `async_checkpoint` are carried for meta.json
    compatibility."""

    batch_size: int = 1024          # global batch
    mini_batch_size: int = 8        # micro-batch (gradient accumulation)
    ctx_len: int = 2048
    lr: float = 1e-2                # µP LR; scaled by sqrt(batch_size)/32
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8
    weight_decay: float = 1e-2
    token_budget: float = 20e9
    test_freq: float = 1e7          # tokens between val-loss probes
    save_freq: float = 1e9          # tokens between checkpoints
    save_name: str = "omnibiota"
    save_dir: str = "checkpoints"
    force_lr: bool = False          # disable µP per-group LR scaling
    # mup MuAdamW decoupled_wd: False (mup + reference default) scales
    # matrix-like weight decay by width_mult so effective decay lr*wd is
    # uniform; True leaves decay unscaled.
    mup_decoupled_wd: bool = False
    banned_token: Optional[int] = None
    warmup_period: float = 0.05     # fraction of iters for the batch ramp
    batch_ramp: bool = False
    train_type: str = "mixed"       # protein | nucleotide | mixed | halfnhalf
    use_padding: bool = False
    resume_from: int = 0            # token count to resume from
    base_dir: str = ""
    mask_prob: float = 0.15
    grad_clip: float = 1.0
    seed: int = 0

    dp_axis: str = "data"
    mesh_shape: Optional[Tuple[int, ...]] = None
    sharding: str = "replicated"
    rng_impl: str = "rbg"
    log_every: int = 1
    async_checkpoint: bool = False
    # Adam moment storage dtype ('float32' | 'bfloat16'); the update math
    # runs in fp32 either way.
    moment_dtype: str = "float32"
    # Gradient dtype handed to the optimizer on the A=1 path ('float32' |
    # 'bfloat16'); accumulating paths always carry fp32.
    grad_dtype: str = "float32"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @property
    def mixture(self):
        """(train_dirs, val_dirs, names, proportions) per train_type
        (reference train_encoder.py:72-93)."""
        if self.train_type == "protein":
            return (["uniref100/train"], ["uniref100/val"], ["uniref100"], [1.0])
        if self.train_type == "nucleotide":
            return (["genbank/train"], ["genbank/val"], ["genbank"], [1.0])
        if self.train_type == "mixed":
            return (["genbank/train", "uniref100/train"],
                    ["genbank/val", "uniref100/val"],
                    ["genbank", "uniref100"], [0.80, 0.20])
        if self.train_type == "halfnhalf":
            return (["genbank/train", "uniref100/train"],
                    ["genbank/val", "uniref100/val"],
                    ["genbank", "uniref100"], [0.50, 0.50])
        raise ValueError(
            "train_type must be one of 'protein', 'nucleotide', 'mixed', 'halfnhalf'")
