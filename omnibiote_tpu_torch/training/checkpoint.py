"""Checkpoints in the JAX package's single-process directory format:

  params.npz     the JAX parameter tree's flat keys ("blocks/attn/wqkv"...),
                 bfloat16 leaves as raw uint16 bits under a "::bf16" suffix;
  opt_state.npz  the optax chain state's leaves numbered "0".."N" in
                 `jax.tree.leaves` order (utils/convert.py);
  meta.json      step, tokens, the training seed, the data readers'
                 positions and both configurations.

So the JAX Trainer and the port resume from each other's checkpoints. The
training seed is written as the two 32-bit words of the port's integer seed
with rng_impl "raw" (a JAX raw key); a JAX typed key read from meta.json is
mixed into an integer seed. Saves rotate as the reference's do: after a
successful save the previous non-final checkpoint is deleted.

A checkpoint the JAX package saved on a pod holds `params.shard<pid>.npz`
files instead of params.npz, each key "<leaf>@<start>:<stop>,..." naming
the global slice it holds (scalars "<leaf>@"). `load_model_checkpoint`
assembles them; writing that format and resuming a trainer from it are not
ported.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..config import OmniBioTAConfig
from ..models.omnibiota import OmniBioTA
from ..utils.convert import (flatten_tree, jax_opt_state_from_port,
                             jax_params_from_state, nest, opt_state_from_jax,
                             state_from_jax_params)
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


def save_pytree_flat(path: str, flat: Dict[str, object]) -> None:
    """npz of {key: tensor or array}; bfloat16 leaves as uint16 bits under
    a '::bf16' key, as the JAX package writes them."""
    out = {}
    for k, v in flat.items():
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                out[k + _BF16_SUFFIX] = v.view(torch.int16).numpy().view(np.uint16)
                continue
            v = v.numpy()
        out[k] = np.asarray(v)
    np.savez(path, **out)


def _parse_index_key(key: str):
    """"<leaf>@<start>:<stop>,..." -> (leaf key, tuple of slices)."""
    leaf_key, _, idx = key.rpartition("@")
    if not idx:
        return leaf_key, ()
    slices = []
    for part in idx.split(","):
        start, stop = part.split(":")
        slices.append(slice(int(start), int(stop)))
    return leaf_key, tuple(slices)


def _load_all_shards(dirpath: str, name: str):
    """({leaf_key: {index: np.ndarray}}, the bf16 leaves' keys) of every
    `<name>.shard*.npz` in `dirpath`; bf16 pieces keep their uint16 bits."""
    by_leaf: Dict[str, Dict] = {}
    bf16 = set()
    for f in sorted(glob.glob(os.path.join(dirpath, f"{name}.shard*.npz"))):
        with np.load(f, allow_pickle=False) as z:
            for k in z.files:
                is_bf16 = k.endswith(_BF16_SUFFIX)
                leaf_key, index = _parse_index_key(
                    k[:-len(_BF16_SUFFIX)] if is_bf16 else k)
                if is_bf16:
                    bf16.add(leaf_key)
                by_leaf.setdefault(leaf_key, {})[index] = z[k]
    return by_leaf, bf16


def _assemble_leaf(shards: Dict, shape, dtype, leaf_key="") -> np.ndarray:
    """Fill a global ndarray from {index: shard} pieces. The pieces of a
    sharded leaf partition it exactly, so anything other than full coverage
    means a shard file is missing or stale: raise rather than return
    zero-filled regions."""
    if not shape:
        (arr,) = shards.values()
        return np.asarray(arr, dtype=dtype).reshape(())
    out = np.zeros(shape, dtype=dtype)
    filled = 0
    for index, arr in shards.items():
        out[index if index else tuple(slice(0, d) for d in shape)] = arr
        filled += int(arr.size)
    total = int(np.prod(shape))
    if filled != total:
        raise ValueError(
            f"shard coverage mismatch for {leaf_key!r}: {filled} of {total} "
            f"elements present — a .shard*.npz file is missing or duplicated")
    return out


def load_params_flat(path: str) -> Dict[str, torch.Tensor]:
    """Flat {key: CPU tensor} of a checkpoint's parameters: params.npz, or
    else the pod-sharded params.shard*.npz pieces assembled, each leaf's
    shape the largest stop of its pieces."""
    params_file = os.path.join(path, "params.npz")
    if os.path.exists(params_file):
        return load_pytree_flat(params_file)
    by_leaf, bf16 = _load_all_shards(path, "params")
    if not by_leaf:
        raise FileNotFoundError(f"{path} holds neither params.npz nor params.shard*.npz")
    flat = {}
    for leaf_key, shards in by_leaf.items():
        stops = [max(s[d].stop for s in shards if s)
                 for d in range(len(next(iter(shards))))]
        dtype = next(iter(shards.values())).dtype
        arr = torch.from_numpy(_assemble_leaf(shards, tuple(stops), dtype, leaf_key))
        flat[leaf_key] = (arr.view(torch.int16).view(torch.bfloat16)
                          if leaf_key in bf16 else arr)
    return flat


def load_model_checkpoint(path: str, *, device=None):
    """(OmniBioTA, model cfg) from a checkpoint directory, single-process or
    pod-sharded, on `device` (None: the GPU)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    fields = OmniBioTAConfig.__dataclass_fields__
    cfg = OmniBioTAConfig(**{k: v for k, v in meta["model_cfg"].items()
                             if k in fields})
    state = state_from_jax_params(nest(load_params_flat(path)), cfg)
    model = OmniBioTA(cfg, device=dev)
    model.load_state_dict(state, strict=True)
    return model, cfg


def save_model_checkpoint(model: OmniBioTA, path: str) -> str:
    """A checkpoint directory of the model's weights alone, which
    `load_model_checkpoint` of either package reads: params.npz in the JAX
    layout and meta.json's model_cfg."""
    os.makedirs(path)
    state = {n: p.detach().cpu() for n, p in model.named_parameters()}
    save_pytree_flat(os.path.join(path, "params.npz"),
                     flatten_tree(jax_params_from_state(state, model.cfg)))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"model_cfg": dict(vars(model.cfg))}, f)
    return path


def _seed_words(seed: int):
    return [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]


def _seed_from_meta(meta: dict) -> int:
    words = [int(w) for w in np.asarray(meta["rng"]).reshape(-1)]
    if meta.get("rng_impl", "raw") == "raw" and len(words) == 2:
        return words[0] | (words[1] << 32)
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def _build_meta(trainer) -> dict:
    return {
        "step": trainer.step,
        "trained_tokens": int(trainer.trained_tokens),
        "total_iters": trainer.total_iters,
        "data_hosts": 1,
        "rng": _seed_words(trainer.rng),
        "rng_impl": "raw",
        "reader_states": [s.to_dict()
                          for s in trainer.reader_states_for_checkpoint()],
        "model_cfg": dict(vars(trainer.model_cfg)),
        "train_cfg": {k: (list(v) if isinstance(v, tuple) else v)
                      for k, v in vars(trainer.train_cfg).items()},
        "sharded": False,
    }


def save_checkpoint(trainer, final: bool = False,
                    async_save: bool = False) -> str:
    """Snapshot the trainer to the host and write its checkpoint directory.
    async_save=True writes from a background thread (the snapshot stays
    synchronous); saves are serialised, and Trainer.close() joins the last
    one."""
    trainer.wait_for_checkpoint()
    tc = trainer.train_cfg
    tokens = int(trainer.trained_tokens)
    name = tc.save_name if final else f"{tc.save_name}_{tokens}"
    path = os.path.join(tc.save_dir, name)
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)   # a crashed earlier save
    os.makedirs(tmp)

    cfg = trainer.model_cfg
    state = {n: p.detach().cpu() for n, p in trainer.params.items()}
    params_flat = flatten_tree(jax_params_from_state(state, cfg))
    host_opt = _opt_state_to_cpu(trainer.opt_state)
    opt_flat = {str(i): leaf for i, leaf in
                enumerate(jax_opt_state_from_port(host_opt, cfg))}
    meta = _build_meta(trainer)
    prev_path = trainer._last_ckpt_path

    def write():
        save_pytree_flat(os.path.join(tmp, "params.npz"), params_flat)
        save_pytree_flat(os.path.join(tmp, "opt_state.npz"), opt_flat)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        # rotate: delete the previous non-final checkpoint
        if prev_path and prev_path != path and os.path.exists(prev_path) \
                and not final:
            shutil.rmtree(prev_path)

    if async_save:
        def runner():
            try:
                write()
                trainer._last_ckpt_path = path
            except BaseException as e:  # re-raised at the next join
                t.exc = e

        t = threading.Thread(target=runner, daemon=True)
        t.exc = None
        t.start()
        trainer._ckpt_thread = t
    else:
        write()
        trainer._last_ckpt_path = path
    return path


def _opt_state_to_cpu(opt_state):
    """A copy of an OptState with its tensors on the CPU."""
    from ..training.optim import OptState
    return OptState(
        grad_norm=opt_state.grad_norm.detach().cpu(), count=opt_state.count,
        mu={k: v.detach().cpu() for k, v in opt_state.mu.items()},
        nu={k: v.detach().cpu() for k, v in opt_state.nu.items()},
        sched_count=opt_state.sched_count)


@torch.no_grad()
def restore_into_trainer(trainer, path: str) -> None:
    """Load parameters, optimizer state, step, seed and data-stream
    position from `path` into `trainer` (a checkpoint of either package)."""
    from ..data.loader import ReaderState

    params_file = os.path.join(path, "params.npz")
    if not os.path.exists(params_file):
        raise NotImplementedError(
            f"{path} has no params.npz: resuming a trainer from the pod-sharded "
            "checkpoint format is not ported yet (ROADMAP Queue 1, item 9)")
    # stop the staged stream first: its prefetch worker advances the live
    # reader states this restore is about to assign
    if trainer._staged is not None and hasattr(trainer._staged, "close"):
        trainer._staged.close()
    trainer._staged = None

    cfg = trainer.model_cfg
    state = state_from_jax_params(nest(load_pytree_flat(params_file)), cfg)
    for n, p in trainer.params.items():
        p.copy_(state[n])
    opt_flat = load_pytree_flat(os.path.join(path, "opt_state.npz"))
    loaded = opt_state_from_jax([opt_flat[str(i)] for i in range(len(opt_flat))], cfg)
    st = trainer.opt_state
    for src, dst in ((loaded.mu, st.mu), (loaded.nu, st.nu)):
        for n, t in dst.items():
            t.copy_(src[n])
    st.grad_norm = loaded.grad_norm.to(st.grad_norm.device)
    st.count, st.sched_count = loaded.count, loaded.sched_count

    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if int(meta.get("data_hosts", 1)) != 1:
        raise NotImplementedError(
            "checkpoint saved with data_hosts > 1: per-host streams are not "
            "ported yet (ROADMAP Queue 1, item 9)")
    trainer.step = int(meta["step"])
    trainer.trained_tokens = int(meta["trained_tokens"])
    trainer.rng = _seed_from_meta(meta)
    restored = [ReaderState.from_dict(d) for d in meta["reader_states"]]
    if len(trainer.reader_states) == len(restored):
        # mutate the live objects: the pipeline's readers hold references
        # to them, so the stream resumes without being rebuilt
        for live, new in zip(trainer.reader_states, restored):
            live.assign(new)
    else:
        trainer.reader_states = restored
    trainer._reader_snapshots = {}
    trainer._grand = trainer._grand_seg = None
    trainer._last_ckpt_path = path


def latest_checkpoint(save_dir: str, save_name: str) -> Optional[str]:
    """The checkpoint directory of `save_name` with the most tokens."""
    if not os.path.isdir(save_dir):
        return None
    best, best_tok = None, -1
    for d in os.listdir(save_dir):
        full = os.path.join(save_dir, d)
        if not os.path.isdir(full) or not d.startswith(save_name) \
                or d.endswith(".tmp"):
            continue
        suffix = d[len(save_name):].lstrip("_")
        tok = int(suffix) if suffix.isdigit() else 0
        if tok > best_tok:
            best, best_tok = full, tok
    return best
