"""PyTorch port vs the JAX package: reading a pod-sharded checkpoint.

A checkpoint the JAX package saves on a pod holds `params.shard<pid>.npz`
files, each key "<leaf>@<start>:<stop>,..." the global slice it holds and
bf16 pieces as uint16 bits under a "::bf16" suffix. The files here are
written with numpy in that layout (every leaf cut in two along each of its
first two axes, the pieces dealt round the files): both packages assemble
the same arrays, bit for bit, and the port's model loads the same weights
as from the single params.npz; a missing shard file raises in both.
"""
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from omnibiote_tpu.training import checkpoint as jckpt
from omnibiote_tpu_torch import OmniBioTAConfig, init_params
from omnibiote_tpu_torch.training.checkpoint import (
    load_model_checkpoint, load_params_flat, save_model_checkpoint)

N_SHARDS = 4


def _pieces(arr):
    """(index key, piece) of `arr` cut in two along each of its first two
    axes (an axis of 1 stays whole)."""
    if arr.ndim == 0:
        return [("", arr)]
    cuts = [[(0, d)] if d < 2 else [(0, d // 2), (d // 2, d)] for d in arr.shape[:2]]
    out = []
    for first in cuts[0]:
        for second in (cuts[1] if arr.ndim > 1 else [None]):
            spans = [first] + ([second] if second else [])
            spans += [(0, d) for d in arr.shape[len(spans):]]
            out.append((",".join(f"{a}:{b}" for a, b in spans),
                        arr[tuple(slice(a, b) for a, b in spans)]))
    return out


def write_shards(flat, root):
    """params.shard<i>.npz files of the flat tree `flat` (numpy), as the
    JAX package's pod save lays them out."""
    files = [{} for _ in range(N_SHARDS)]
    n = 0
    for key, arr in flat.items():
        for idx, piece in _pieces(np.ascontiguousarray(arr)):
            name = f"{key}@{idx}"
            if piece.dtype == ml_dtypes.bfloat16:
                name, piece = name + "::bf16", piece.view(np.uint16)
            files[n % N_SHARDS][name] = piece
            n += 1
    for i, content in enumerate(files):
        np.savez(os.path.join(root, f"params.shard{i}.npz"), **content)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(params.npz directory, sharded directory, flat numpy tree) of a
    2-layer d-64 model; wte is a bf16 leaf in both."""
    root = tmp_path_factory.mktemp("shards")
    cfg = OmniBioTAConfig(n_layer=2, n_head=2, n_embd=64, vocab_size=96,
                          block_size=64, dropout=0.0, compute_dtype="float32")
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    whole = save_model_checkpoint(model, str(root / "whole"))
    flat = {k: v.numpy() for k, v in load_params_flat(whole).items()}
    flat["wte"] = flat["wte"].astype(ml_dtypes.bfloat16)
    jckpt.save_pytree(os.path.join(whole, "params.npz"), _nest(flat))
    sharded = str(root / "sharded")
    os.makedirs(sharded)
    write_shards(flat, sharded)
    with open(os.path.join(whole, "meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(sharded, "meta.json"), "w") as f:
        json.dump(meta, f)
    return whole, sharded, flat


def _nest(flat):
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _bits(x):
    """The raw bits of a numpy or torch array (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def test_layout_has_many_pieces(checkpoints):
    _, sharded, flat = checkpoints
    keys = []
    for i in range(N_SHARDS):
        with np.load(os.path.join(sharded, f"params.shard{i}.npz")) as z:
            keys += z.files
    assert "wte@0:48,0:32::bf16" in keys and "wte@48:96,32:64::bf16" in keys
    assert sum(k.startswith("blocks/attn/wqkv@") for k in keys) == 4
    assert len(keys) > 2 * len(flat)


def test_both_packages_assemble_the_same_arrays(checkpoints):
    whole, sharded, flat = checkpoints
    got = load_params_flat(sharded)
    want, _ = jckpt.load_model_checkpoint(sharded)
    want = {k: np.asarray(v) for k, v in jckpt._flatten(want).items()}
    assert set(got) == set(want) == set(flat)
    assert got["wte"].dtype == torch.bfloat16 and want["wte"].dtype == ml_dtypes.bfloat16
    for k in flat:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=k)
        np.testing.assert_array_equal(_bits(got[k]), _bits(flat[k]), err_msg=k)
    whole_flat = load_params_flat(whole)
    for k in flat:
        assert got[k].dtype == whole_flat[k].dtype, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(whole_flat[k]), err_msg=k)


def test_port_model_loads_sharded_bit_for_bit(checkpoints):
    whole, sharded, _ = checkpoints
    a, cfg_a = load_model_checkpoint(whole, device="cpu")
    b, cfg_b = load_model_checkpoint(sharded, device="cpu")
    assert cfg_a == cfg_b
    sa, sb = a.state_dict(), b.state_dict()
    assert set(sa) == set(sb)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


def test_missing_shard_raises_in_both(checkpoints, tmp_path):
    _, sharded, _ = checkpoints
    for f in os.listdir(sharded):
        if f != "params.shard1.npz":
            os.symlink(os.path.join(sharded, f), tmp_path / f)
    with pytest.raises(ValueError, match="shard coverage mismatch"):
        load_params_flat(str(tmp_path))
    with pytest.raises(ValueError, match="shard coverage mismatch"):
        load_model_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="shard coverage mismatch"):
        jckpt.load_model_checkpoint(str(tmp_path))
