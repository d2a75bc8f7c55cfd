"""Weights between the JAX package's parameter tree and the reference
state_dict layout that the port's OmniBioTA uses.

The JAX tree stores linear weights (fan_in, fan_out) and stacks the blocks
on a leading layer axis:

  wte (V, D); lm_head (D, V); ln_f {scale[, bias]}
  blocks: ln1/ln2 {scale[, bias]} (L, D); attn {wqkv (L, D, 3D), wo (L, D, D)
          [, bqkv (L, 3D), bo (L, D)]}; mlp {wi (L, D, 4D), wo (L, 4D, D)
          [, bi (L, 4D), bo (L, D)]}

Both directions carry the bias leaves when cfg.bias is set. Leaves may be
numpy arrays or torch tensors; the result holds the same kind, in the same
dtype.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from ..config import OmniBioTAConfig

# (block sub-tree, leaf) -> reference name inside transformer.h.{i}, and
# whether the leaf is a linear weight (transposed between the layouts)
_BLOCK_LEAVES = [
    (("ln1", "scale"), "ln_1.weight", False),
    (("ln2", "scale"), "ln_2.weight", False),
    (("attn", "wqkv"), "attn.c_attn.weight", True),
    (("attn", "wo"), "attn.c_proj.weight", True),
    (("mlp", "wi"), "mlp.c_fc.weight", True),
    (("mlp", "wo"), "mlp.c_proj.weight", True),
]
_BLOCK_BIAS_LEAVES = [
    (("ln1", "bias"), "ln_1.bias", False),
    (("ln2", "bias"), "ln_2.bias", False),
    (("attn", "bqkv"), "attn.c_attn.bias", False),
    (("attn", "bo"), "attn.c_proj.bias", False),
    (("mlp", "bi"), "mlp.c_fc.bias", False),
    (("mlp", "bo"), "mlp.c_proj.bias", False),
]


def _block_leaves(cfg: OmniBioTAConfig):
    return _BLOCK_LEAVES + (_BLOCK_BIAS_LEAVES if cfg.bias else [])


def state_from_jax_params(params: Mapping, cfg: OmniBioTAConfig) -> Dict[str, object]:
    """JAX parameter tree -> reference state_dict (bias leaves included)."""
    out = {
        "transformer.wte.weight": params["wte"],
        "transformer.ln_f.weight": params["ln_f"]["scale"],
        "lm_head.weight": params["lm_head"].T,
    }
    if cfg.bias:
        out["transformer.ln_f.bias"] = params["ln_f"]["bias"]
    blocks = params["blocks"]
    for i in range(cfg.n_layer):
        for (sub, leaf), name, is_weight in _block_leaves(cfg):
            x = blocks[sub][leaf][i]
            out[f"transformer.h.{i}.{name}"] = x.T if is_weight else x
    return out


def _stack(xs):
    return torch.stack(xs) if isinstance(xs[0], torch.Tensor) else np.stack(xs)


def jax_params_from_state(state: Mapping, cfg: OmniBioTAConfig) -> Dict:
    """Reference state_dict -> JAX parameter tree (bias leaves included)."""
    params = {
        "wte": state["transformer.wte.weight"],
        "ln_f": {"scale": state["transformer.ln_f.weight"]},
        "lm_head": state["lm_head.weight"].T,
        "blocks": {},
    }
    if cfg.bias:
        params["ln_f"]["bias"] = state["transformer.ln_f.bias"]
    for (sub, leaf), name, is_weight in _block_leaves(cfg):
        xs = [state[f"transformer.h.{i}.{name}"] for i in range(cfg.n_layer)]
        params["blocks"].setdefault(sub, {})[leaf] = _stack(
            [x.T if is_weight else x for x in xs])
    return params
