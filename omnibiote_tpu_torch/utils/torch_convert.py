"""Reference PyTorch OmniBioTE checkpoints (.pt) into the port.

Counterpart of `omnibiote_tpu/utils/torch_convert.py`. The reference saves
whole pickled modules (its train_encoder.py: `torch.save(model.module,
...)`); users also hold bare state_dicts, or dicts that wrap one. Its
state_dict layout is the port's own (`models/omnibiota.py`):

  transformer.wte.weight               (V, D)
  transformer.h.{i}.ln_1.weight        (D,)      [+ .bias when bias=True]
  transformer.h.{i}.attn.c_attn.weight (3D, D)
  transformer.h.{i}.attn.c_proj.weight (D, D)
  transformer.h.{i}.attn.freqs_cis     (block_size, head_dim/2) complex64
  transformer.h.{i}.ln_2.weight        (D,)
  transformer.h.{i}.mlp.c_fc.weight    (4D, D)
  transformer.h.{i}.mlp.c_proj.weight  (D, 4D)
  transformer.ln_f.weight              (D,)
  lm_head.weight                       (V, D)

`load_torch_checkpoint` returns the parameters in that layout as fp32 CPU
tensors, which `OmniBioTA(cfg).load_state_dict(state, strict=True)` takes;
the persistent RoPE buffer `freqs_cis` only gives the config its
block_size and n_head. `save_converted_checkpoint` writes the JAX
package's checkpoint directory (params.npz in the JAX tree's layout,
meta.json), which either package's `load_model_checkpoint` reads, and with
it every entry point that takes `--checkpoint`.

    python -m omnibiote_tpu_torch.utils.torch_convert model.pt out_dir \\
        [--reference_path REPO] [--mup_base_n_embd 24]
"""
from __future__ import annotations

import json
import os
import sys
import types
from typing import Dict, Mapping

import numpy as np
import torch

from ..config import OmniBioTAConfig
from .convert import flatten_tree, jax_params_from_state, torch_leaf_map

# the keys a bare state_dict may sit under in a wrapping dict, in the order
# they are tried
_WRAPPER_KEYS = ("model", "state_dict", "model_state_dict")


def _fp32(x) -> torch.Tensor:
    """An fp32 CPU tensor of a tensor (bf16 and fp16 cast up) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float()
    return torch.from_numpy(np.array(x, dtype=np.float32))


def strip_prefixes(state: Mapping[str, object]) -> Dict[str, object]:
    """Drop DDP/compile wrappers ('module.', '_orig_mod.') from key names."""
    out = {}
    for k, v in state.items():
        for pre in ("module.", "_orig_mod."):
            while k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def infer_config_from_torch_state(state: Mapping[str, object],
                                  mup_base_n_embd: int = 24,
                                  dropout: float = 0.0) -> OmniBioTAConfig:
    """The model config of a bare reference state_dict, from shapes alone:
    (V, D) from wte; L from the block indices; bias from whether
    ln_f.bias is there; block_size and n_head = D / head_dim from the
    persistent RoPE buffer freqs_cis, (block_size, head_dim / 2) (only its
    shape is read). mup_base_n_embd defaults to the reference's base width
    of 24."""
    V, D = tuple(state["transformer.wte.weight"].shape)
    L = 1 + max(int(k.split(".")[2]) for k in state
                if k.startswith("transformer.h."))
    bias = "transformer.ln_f.bias" in state
    block_size, half = tuple(state["transformer.h.0.attn.freqs_cis"].shape)
    return OmniBioTAConfig(
        block_size=int(block_size), vocab_size=int(V), n_layer=int(L),
        n_head=int(D) // (2 * int(half)), n_embd=int(D), bias=bias,
        dropout=dropout, mup_base_n_embd=mup_base_n_embd)


def _mup_stub() -> types.ModuleType:
    """A stand-in `mup` module whose MuReadout is a plain nn.Linear: the
    reference's model.py imports it, and the package is not installed. The
    class is named mup.MuReadout, so a module built on it pickles as one
    built on the real package does."""
    class MuReadout(torch.nn.Linear):
        pass

    MuReadout.__module__, MuReadout.__qualname__ = "mup", "MuReadout"
    stub = types.ModuleType("mup")
    stub.MuReadout = MuReadout
    return stub


def _unpickle(path: str, reference_path: str):
    """torch.load of a .pt, with `reference_path` and its training/ on
    sys.path and a `mup` stub installed (where no `mup` is imported) for the
    load alone: a pickled module's classes import from there."""
    inserted = []
    if reference_path:
        for p in (reference_path, os.path.join(reference_path, "training")):
            if os.path.isdir(p):
                sys.path.insert(0, p)
                inserted.append(p)
    stubbed = "mup" not in sys.modules
    if stubbed:
        sys.modules["mup"] = _mup_stub()
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    finally:
        for p in inserted:
            sys.path.remove(p)
        if stubbed:
            sys.modules.pop("mup", None)


def load_torch_checkpoint(path: str, reference_path: str = "",
                          mup_base_n_embd: int = 24):
    """(state, cfg) from a reference .pt file: `state` the parameters as
    fp32 CPU tensors in the reference layout (the keys of
    `convert.torch_leaf_map(cfg)`, bias leaves when cfg.bias; every other
    key, the freqs_cis buffers among them, is left out).

    Takes the three formats the JAX package's converter takes:
      * a whole pickled module, the reference's own save format; unpickling
        needs the reference's model.py importable, so pass reference_path
        (the repo root or its training/ dir); its `mup` import is stubbed;
        the config is the module's `.config`;
      * a bare state_dict;
      * a dict wrapping one under 'model', 'state_dict' or
        'model_state_dict'.
    Key prefixes 'module.' and '_orig_mod.' are dropped. Without a module's
    config, it is inferred from the shapes. dropout is 0 either way."""
    obj = _unpickle(path, reference_path)
    ref_cfg = None
    if hasattr(obj, "state_dict"):
        ref_cfg = getattr(obj, "config", None)
        obj = obj.state_dict()
    if not isinstance(obj, Mapping):
        raise ValueError(f"unsupported checkpoint object: {type(obj)}")
    for key in _WRAPPER_KEYS:
        if key in obj and isinstance(obj[key], Mapping):
            obj = obj[key]
            break
    raw = strip_prefixes(obj)
    if ref_cfg is not None:
        cfg = OmniBioTAConfig(
            block_size=int(ref_cfg.block_size), vocab_size=int(ref_cfg.vocab_size),
            n_layer=int(ref_cfg.n_layer), n_head=int(ref_cfg.n_head),
            n_embd=int(ref_cfg.n_embd), bias=bool(ref_cfg.bias), dropout=0.0,
            mup_base_n_embd=mup_base_n_embd)
    else:
        cfg = infer_config_from_torch_state(raw, mup_base_n_embd=mup_base_n_embd)
    return {name: _fp32(raw[name]) for name in torch_leaf_map(cfg)}, cfg


def save_converted_checkpoint(state: Mapping[str, torch.Tensor],
                              cfg: OmniBioTAConfig, out_dir: str) -> str:
    """Write `state` and `cfg` as the JAX package's checkpoint directory
    (params.npz in the JAX tree's layout, meta.json with model_cfg), as the
    JAX converter writes it."""
    from ..training.checkpoint import save_pytree_flat

    os.makedirs(out_dir, exist_ok=True)
    save_pytree_flat(os.path.join(out_dir, "params.npz"),
                     flatten_tree(jax_params_from_state(state, cfg)))
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump({"model_cfg": dict(vars(cfg)),
                   "converted_from": "reference torch checkpoint"},
                  f, indent=2, default=str)
    return out_dir


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a reference OmniBioTE torch checkpoint (.pt) into "
                    "a checkpoint directory (the JAX package's format, which "
                    "omnibiote_tpu_torch reads)")
    ap.add_argument("src", help=".pt file (pickled module or state_dict)")
    ap.add_argument("out_dir", help="output checkpoint directory")
    ap.add_argument("--reference_path", default="",
                    help="reference repo root, needed to unpickle "
                         "whole-module saves")
    ap.add_argument("--mup_base_n_embd", type=int, default=24,
                    help="µP base width used at training time "
                         "(reference default: 24)")
    args = ap.parse_args(argv)
    state, cfg = load_torch_checkpoint(
        args.src, reference_path=args.reference_path,
        mup_base_n_embd=args.mup_base_n_embd)
    save_converted_checkpoint(state, cfg, args.out_dir)
    n = sum(int(x.numel()) for x in state.values())
    print(f"converted {n:,} params "
          f"({cfg.n_layer}L/{cfg.n_embd}d/{cfg.n_head}h, "
          f"block_size {cfg.block_size}, bias={cfg.bias}) -> {args.out_dir}")


if __name__ == "__main__":
    main()
