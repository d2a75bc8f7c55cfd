"""Checkpoint reading: the `params.npz` + `meta.json` directory format that
the JAX package's Trainer writes (flat npz keys "a/b/c", bfloat16 leaves as
raw uint16 bits under a "::bf16" suffix). Read side only; the training
checkpoint (optimizer state, data stream position) comes with the training
slice.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from ..config import OmniBioTAConfig
from ..models.omnibiota import OmniBioTA
from ..utils.convert import state_from_jax_params
from ..utils.device import resolve_device

_BF16_SUFFIX = "::bf16"


def load_pytree_flat(path: str) -> Dict[str, torch.Tensor]:
    """Flat {key: CPU tensor} of an npz; '::bf16' leaves (uint16 bits) are
    re-viewed as torch.bfloat16."""
    out = {}
    with np.load(path, allow_pickle=False) as z:
        for k in z.files:
            arr = z[k]
            if k.endswith(_BF16_SUFFIX):
                out[k[:-len(_BF16_SUFFIX)]] = torch.from_numpy(
                    arr.view(np.int16)).view(torch.bfloat16)
            else:
                out[k] = torch.from_numpy(arr)
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for key, arr in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


def load_model_checkpoint(path: str, *, device=None):
    """(OmniBioTA, model cfg) from a checkpoint directory, on `device`
    (None: the GPU)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    fields = OmniBioTAConfig.__dataclass_fields__
    cfg = OmniBioTAConfig(**{k: v for k, v in meta["model_cfg"].items()
                             if k in fields})
    params_file = os.path.join(path, "params.npz")
    if not os.path.exists(params_file):
        raise NotImplementedError(
            f"{path} has no params.npz: the pod-sharded checkpoint format is "
            "not ported yet (ROADMAP Queue 1, item 5)")
    state = state_from_jax_params(_nest(load_pytree_flat(params_file)), cfg)
    model = OmniBioTA(cfg, device=dev)
    model.load_state_dict(state, strict=True)
    return model, cfg
