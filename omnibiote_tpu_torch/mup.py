"""Maximal Update Parametrisation (µP) multipliers over named parameters.

Counterpart of `omnibiote_tpu/mup.py` for the port's `state_dict` names.
Every dimension proportional to n_embd is "infinite", vocab_size is finite:

  parameter                                   class        µP treatment
  ---------------------------------------------------------------------
  transformer.wte.weight (V, D)               vector-like  full LR
  transformer.h.*.ln_{1,2}.*, ln_f.*          vector-like  full LR
  transformer.h.*.attn.c_attn.weight (3D, D)  matrix-like  LR / width_mult
  transformer.h.*.attn.c_proj.weight (D, D)   matrix-like  LR / width_mult
  transformer.h.*.mlp.c_fc.weight (4D, D)     matrix-like  LR / width_mult
  transformer.h.*.mlp.c_proj.weight (D, 4D)   matrix-like  LR / width_mult
  lm_head.weight (V, D)                       vector-like  full LR (the
                                              forward divides by width_mult)

Biases are vector-like. mup's default (decoupled_wd=False) multiplies the
matrix-like groups' weight decay by width_mult, so the effective decay
lr·wd is uniform; `decoupled=True` leaves it unscaled.
"""
from __future__ import annotations

from typing import Dict, Iterable

from .config import OmniBioTAConfig

# the linear weights whose both dimensions scale with width (the JAX
# package's leaves wqkv, wo, wi)
MATRIX_LIKE_SUFFIXES = (".attn.c_attn.weight", ".attn.c_proj.weight",
                        ".mlp.c_fc.weight", ".mlp.c_proj.weight")


def is_matrix_like(name: str) -> bool:
    """True for parameters whose both dimensions scale with width."""
    return name.startswith("transformer.h.") and name.endswith(MATRIX_LIKE_SUFFIXES)


def lr_mult_tree(names: Iterable[str], cfg: OmniBioTAConfig,
                 force_lr: bool = False) -> Dict[str, float]:
    """{name: LR multiplier}: 1/width_mult for matrix-like parameters, 1.0
    otherwise; all ones with force_lr (the reference's --force_lr)."""
    wm = cfg.width_mult
    return {n: 1.0 if force_lr or not is_matrix_like(n) else 1.0 / wm
            for n in names}


def wd_mult_tree(names: Iterable[str], cfg: OmniBioTAConfig,
                 force_lr: bool = False, decoupled: bool = False
                 ) -> Dict[str, float]:
    """{name: weight-decay multiplier}: width_mult for matrix-like
    parameters (mup's decoupled_wd=False), 1.0 otherwise."""
    wm = cfg.width_mult
    return {n: 1.0 if force_lr or decoupled or not is_matrix_like(n) else wm
            for n in names}
