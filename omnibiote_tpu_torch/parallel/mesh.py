"""Process group, device mesh and the rank's rows of a batch.

Port of `omnibiote_tpu/parallel/mesh.py`. One process drives one GPU, as
`torchrun` starts them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT); the ranks form a `torch.distributed.device_mesh.DeviceMesh`
with the JAX axis names 'data' and 'model' (or 'data' and 'seq' for
sequence parallelism, 'data' and 'stage' for the pipeline), laid out as
the JAX package reshapes its device list (rank = data_index * n_model +
model_index).

The global batch is split over 'data' by rows: data rank d holds rows
[d·per, (d+1)·per) of every micro-batch, the layout of JAX's
`shard_batch_pytree`; with a 'seq' axis, seq rank s also holds only
positions [s·Tl, (s+1)·Tl) of them. Where GSPMD inserts collectives, the
port writes them out: gradients are reduced once per step after
accumulation (training/train.py), scalar metrics are all-reduced, the
tensor-parallel layers carry their own (parallel/tensor.py), and so does
the ring (ops/ring_attention.py).

The backend follows the device: NCCL for CUDA, gloo for the CPU.
"""
from __future__ import annotations

import os
import socket
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..utils.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"     # the sequence axis of sp and dp x sp meshes
STAGE_AXIS = "stage"  # the pipeline's axis of pp, dp x pp and fsdp+pp meshes


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> torch.device:
    """Join the process group (starting it if needed) and return this
    rank's device: `cuda:LOCAL_RANK` (None: the GPU), or the CPU when asked.

    Under torchrun the group comes from its environment; a process started
    without it forms a group of one on a free localhost port."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                rank=0, world_size=1)
    return dev


def make_mesh(mesh_shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (DATA_AXIS,), device=None):
    """A DeviceMesh over every rank of the (initialised) process group.
    mesh_shape None puts all ranks on 'data'; a shape whose product is not
    the world size is an error."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_distributed(device)
    world = dist.get_world_size()
    if mesh_shape is None:
        mesh_shape, axis_names = (world,), (DATA_AXIS,)
    mesh_shape = tuple(int(n) for n in mesh_shape)
    axis_names = tuple(axis_names)[:len(mesh_shape)]
    n = 1
    for s in mesh_shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh shape {mesh_shape} != {world} ranks")
    return init_device_mesh(dev.type, mesh_shape, mesh_dim_names=axis_names)


def axis_size(mesh, name: str) -> int:
    """Ranks along `name` (1 for an axis the mesh lacks, or no mesh)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along `name` (0 for a missing axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of this rank's line along `name`, or None."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return None
    return mesh.get_group(name)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rows(v, lo: int, hi: int, batch_dim: int):
    idx = [slice(None)] * v.ndim
    idx[batch_dim] = slice(lo, hi)
    return v[tuple(idx)]


def shard_batch_pytree(mesh, batch: dict, batch_dim: int = 0,
                       seq_dim: Optional[int] = None) -> dict:
    """This rank's tile of a global batch dict: data rank d takes rows
    [d·per, (d+1)·per) of dimension `batch_dim` (per = rows / n_data), and
    with seq_dim, seq rank s positions [s·Tl, (s+1)·Tl) of that dimension
    (Tl = its length / n_seq)."""
    cuts = [(batch_dim, DATA_AXIS)] + ([] if seq_dim is None else [(seq_dim, SEQ_AXIS)])
    out = dict(batch)
    for dim, axis in cuts:
        n, i = axis_size(mesh, axis), axis_index(mesh, axis)
        for k, v in out.items():
            size = v.shape[dim]
            if size % n:
                raise ValueError(f"{k}: {size} entries of dimension {dim} do not "
                                 f"split over {n} {axis} ranks")
            per = size // n
            out[k] = _rows(v, i * per, (i + 1) * per, dim)
    return out
