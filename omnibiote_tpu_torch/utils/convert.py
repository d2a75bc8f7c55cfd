"""Weights and optimizer state between the JAX package's trees and the
reference state_dict layout that the port's OmniBioTA uses.

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

from typing import Dict, List, Mapping, Sequence

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


def jax_tree_keys(cfg: OmniBioTAConfig) -> List[str]:
    """The flat keys of the JAX parameter tree, in `jax.tree.leaves`
    order."""
    skeleton: Dict = {"wte": 0, "lm_head": 0, "ln_f": {"scale": 0}, "blocks": {}}
    if cfg.bias:
        skeleton["ln_f"]["bias"] = 0
    for (sub, leaf), _, _ in _block_leaves(cfg):
        skeleton["blocks"].setdefault(sub, {})[leaf] = 0
    return list(flatten_tree(skeleton))


def nest(flat: Mapping[str, object]) -> Dict:
    """{"a/b/c": leaf} -> nested dicts."""
    tree: Dict = {}
    for key, leaf in flat.items():
        node = tree
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = leaf
    return tree


def flatten_tree(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    """{"a/b/c": leaf} with dict keys in sorted order at every level: the
    keys of the JAX package's checkpoint npz files, in the order of
    `jax.tree.leaves` for a tree of dicts."""
    out: Dict[str, object] = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.update(flatten_tree(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def as_tensor(x) -> torch.Tensor:
    """A tensor of a numpy array (ml_dtypes bfloat16 included) or tensor."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def jax_opt_state_from_port(state, cfg: OmniBioTAConfig) -> List[object]:
    """The port's OptState -> the leaves of the JAX package's optax chain
    state, in `jax.tree.leaves` order:

      [clip grad_norm, adam count, *adam mu, *adam nu, schedule count]

    with mu and nu in the JAX parameter tree's layout and flat order. Moment
    leaves keep their kind (tensor) and dtype; the counts are int32 numpy
    scalars, the norm an fp32 numpy scalar."""
    mu = flatten_tree(jax_params_from_state(state.mu, cfg))
    nu = flatten_tree(jax_params_from_state(state.nu, cfg))
    return ([np.asarray(float(state.grad_norm), np.float32),
             np.asarray(state.count, np.int32)]
            + list(mu.values()) + list(nu.values())
            + [np.asarray(state.sched_count, np.int32)])


def opt_state_from_jax(leaves: Sequence[object], cfg: OmniBioTAConfig):
    """Leaves of the JAX package's optax chain state (`jax.tree.leaves`
    order, as numpy arrays or tensors) -> the port's OptState, moments as
    CPU tensors in the port's layout."""
    from ..training.optim import OptState

    keys = jax_tree_keys(cfg)
    n = len(keys)
    if len(leaves) != 2 * n + 3:
        raise ValueError(f"{len(leaves)} optimizer leaves, want {2 * n + 3} "
                         "(clip norm, count, mu, nu, schedule count)")

    def moments(flat_leaves):
        tree = nest({k: as_tensor(x) for k, x in zip(keys, flat_leaves)})
        return {k: v.contiguous() for k, v in state_from_jax_params(tree, cfg).items()}

    return OptState(
        grad_norm=torch.as_tensor(np.asarray(leaves[0], np.float32)),
        count=int(np.asarray(leaves[1])),
        mu=moments(leaves[2:2 + n]), nu=moments(leaves[2 + n:2 + 2 * n]),
        sched_count=int(np.asarray(leaves[-1])))
