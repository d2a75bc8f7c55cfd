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

A tree quantized for int8 serving (the JAX package's
`quantize_for_inference`) goes across with `quantized_state_from_jax_params`
and back with `jax_qparams_from_quantized_state`: there each projection leaf
is a pair `values` (fan_in, fan_out) int8, `scale` (fan_out,) fp32 (stacked
on the layer axis inside `blocks`), and becomes `<linear>.values` (fan_out,
fan_in) and `<linear>.scale`, the buffers of the port's QuantizedLinear.
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


def _quantized_pair(leaf):
    """(values, scale) of a quantized projection leaf: a (named) tuple with
    those fields or a mapping with those keys."""
    if isinstance(leaf, Mapping):
        return leaf["values"], leaf["scale"]
    return leaf.values, leaf.scale


def quantized_state_from_jax_params(qparams: Mapping,
                                    cfg: OmniBioTAConfig) -> Dict[str, object]:
    """Quantized JAX tree -> the state_dict of a port model made by
    ops.quant.quantize_for_inference, with the same integers: every
    projection `<linear>.weight` is replaced by `<linear>.values` (fan_out,
    fan_in) int8 and `<linear>.scale` (fan_out,) fp32. The q and k channels
    of wqkv / bqkv arrive already permuted and stay so."""
    values, scale = _quantized_pair(qparams["lm_head"])
    out = {
        "transformer.wte.weight": qparams["wte"],
        "transformer.ln_f.weight": qparams["ln_f"]["scale"],
        "lm_head.values": values.T,
        "lm_head.scale": scale,
    }
    if cfg.bias:
        out["transformer.ln_f.bias"] = qparams["ln_f"]["bias"]
    blocks = qparams["blocks"]
    for (sub, leaf), name, is_weight in _block_leaves(cfg):
        if is_weight:
            values, scale = _quantized_pair(blocks[sub][leaf])
            stem = name[:-len(".weight")]
            for i in range(cfg.n_layer):
                out[f"transformer.h.{i}.{stem}.values"] = values[i].T
                out[f"transformer.h.{i}.{stem}.scale"] = scale[i]
        else:
            for i in range(cfg.n_layer):
                out[f"transformer.h.{i}.{name}"] = blocks[sub][leaf][i]
    return out


def jax_qparams_from_quantized_state(state: Mapping,
                                     cfg: OmniBioTAConfig) -> Dict:
    """The state_dict of a quantized port model -> the quantized JAX tree,
    each projection leaf a dict {"values": (fan_in, fan_out) int8, "scale":
    (fan_out,) fp32} (stacked on the layer axis inside `blocks`), the fields
    of the JAX package's QuantizedWeight."""
    params = {
        "wte": state["transformer.wte.weight"],
        "ln_f": {"scale": state["transformer.ln_f.weight"]},
        "lm_head": {"values": state["lm_head.values"].T,
                    "scale": state["lm_head.scale"]},
        "blocks": {},
    }
    if cfg.bias:
        params["ln_f"]["bias"] = state["transformer.ln_f.bias"]
    for (sub, leaf), name, is_weight in _block_leaves(cfg):
        layer = lambda key: [state[f"transformer.h.{i}.{key}"]
                             for i in range(cfg.n_layer)]
        if is_weight:
            stem = name[:-len(".weight")]
            value = {"values": _stack([x.T for x in layer(f"{stem}.values")]),
                     "scale": _stack(layer(f"{stem}.scale"))}
        else:
            value = _stack(layer(name))
        params["blocks"].setdefault(sub, {})[leaf] = value
    return params


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


def torch_leaf_map(cfg: OmniBioTAConfig) -> Dict[str, tuple]:
    """{state_dict name: (JAX flat key, layer index or None, transposed,
    the tensor's shape)}: where each tensor of the port's model sits in the
    JAX tree (a layer of a stacked `blocks` leaf, transposed for a linear
    weight)."""
    D, V = cfg.n_embd, cfg.vocab_size
    block_shapes = {"ln_1.weight": (D,), "ln_2.weight": (D,),
                    "attn.c_attn.weight": (3 * D, D), "attn.c_proj.weight": (D, D),
                    "mlp.c_fc.weight": (4 * D, D), "mlp.c_proj.weight": (D, 4 * D),
                    "ln_1.bias": (D,), "ln_2.bias": (D,), "attn.c_attn.bias": (3 * D,),
                    "attn.c_proj.bias": (D,), "mlp.c_fc.bias": (4 * D,),
                    "mlp.c_proj.bias": (D,)}
    out = {"transformer.wte.weight": ("wte", None, False, (V, D)),
           "lm_head.weight": ("lm_head", None, True, (V, D)),
           "transformer.ln_f.weight": ("ln_f/scale", None, False, (D,))}
    if cfg.bias:
        out["transformer.ln_f.bias"] = ("ln_f/bias", None, False, (D,))
    for i in range(cfg.n_layer):
        for (sub, leaf), name, is_weight in _block_leaves(cfg):
            out[f"transformer.h.{i}.{name}"] = (f"blocks/{sub}/{leaf}", i, is_weight,
                                               block_shapes[name])
    return out


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


def head_from_jax(head: Mapping, device=None) -> Dict[str, torch.Tensor]:
    """An eval-harness linear head {"w": (in, out), "b": (out,)} of the JAX
    package (arrays or tensors) -> the port's head: the same layout, fp32
    tensors on `device` that require grad."""
    return {k: as_tensor(np.asarray(head[k], np.float32)).to(device).requires_grad_()
            for k in ("w", "b")}


def jax_head_from_port(head: Mapping) -> Dict[str, np.ndarray]:
    """The port's linear head -> {"w": (in, out), "b": (out,)} fp32 numpy
    arrays, the JAX package's head (copies: no view of a live tensor)."""
    return {k: head[k].detach().float().cpu().numpy().copy() for k in ("w", "b")}


# --------------------------------------------------------------------------
# The eval harness's CNNs (evals/contact.py, evals/deepnap.py)
# --------------------------------------------------------------------------

def _conv_state(prefix: str, conv: Mapping) -> Dict[str, object]:
    # conv weights are OIHW in both packages
    return {f"{prefix}.weight": conv["w"], f"{prefix}.bias": conv["b"]}


def _linear_state(prefix: str, lin: Mapping) -> Dict[str, object]:
    # the JAX weight is (fan_in, fan_out), nn.Linear's its transpose
    return {f"{prefix}.weight": lin["w"].T, f"{prefix}.bias": lin["b"]}


def contact_predictor_state_from_jax(cnn: Mapping) -> Dict[str, object]:
    """The JAX package's contact CNN tree (`init_contact_predictor`: conv_in
    and conv_out {w, b}, blocks[i] {conv1, conv2 {w, b}, bn1, bn2 {scale,
    bias}}) -> the state_dict of the port's `evals.contact.ContactPredictor`.
    A gradient tree of the same structure goes across the same way."""
    out = {**_conv_state("conv_in", cnn["conv_in"]),
           **_conv_state("conv_out", cnn["conv_out"])}
    for i, blk in enumerate(cnn["blocks"]):
        for conv in ("conv1", "conv2"):
            out.update(_conv_state(f"blocks.{i}.{conv}", blk[conv]))
        for bn in ("bn1", "bn2"):
            out[f"blocks.{i}.{bn}.scale"] = blk[bn]["scale"]
            out[f"blocks.{i}.{bn}.bias"] = blk[bn]["bias"]
    return out


def deepnap_state_from_jax(params: Mapping) -> Dict[str, object]:
    """The JAX package's DeePNAP tree (`init_deepnap`) -> the state_dict of
    the port's `evals.deepnap.DeePNAP` (linear weights transposed)."""
    out = {}
    for name in ("protein_conv1", "protein_conv2", "dna_conv1", "dna_conv2"):
        out.update(_conv_state(name, params[name]))
    for name in ("int_p1_n1", "int_p1_n2", "int_p2_n1", "int_p2_n2"):
        for j, lin in enumerate(params[name]):
            out.update(_linear_state(f"{name}.{j}", lin))
    for name in ("fc1", "fc2", "fc3", "fc4"):
        out.update(_linear_state(name, params[name]))
    return out
