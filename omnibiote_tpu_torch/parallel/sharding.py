"""Parameter and optimizer-state placement: replicated (DDP), FSDP and
tensor parallel.

Port of `omnibiote_tpu/parallel/sharding.py`. The JAX package annotates its
parameter tree with PartitionSpecs and lets XLA insert the collectives;
here the same rule gives each of the port's named tensors a `Placement`,
and the train step runs the collectives itself:

  * 'replicated' — DDP: every rank holds everything; the gradients are
    all-reduced over 'data' once per step;
  * 'fsdp' — every leaf (and its Adam moments) is split over 'data' along
    the largest dimension that divides by the data-axis size; once per
    step the ranks all-gather the compute-dtype copy, and reduce-scatter
    the gradients;
  * 'tp' / 'fsdp+tp' — Megatron splits over 'model' (parallel/tensor.py),
    fsdp over 'data' on the largest dimension still free;
  * 'sp' — sequence parallelism: every rank holds everything (as
    'replicated') on a ('seq',) or ('data', 'seq') mesh; a rank's batch
    tile is its rows and its block of positions, so the gradients are
    all-reduced over both axes, and the seq axis's ranks share the ring
    (ops/ring_attention.py).
  * 'pp' / 'fsdp+pp' — the pipeline (parallel/pipeline.py) on a
    ('stage',) or ('data', 'stage') mesh: stage s holds the blocks of the
    layers [s·L/S, (s+1)·L/S) and every stage the embedding, ln_f and the
    head, whose gradients are summed over 'stage' before the clip norm;
    fsdp+pp also splits every tensor over 'data' (the JAX package's
    `pp_param_pspecs`, whose dimension rule takes the first of equal
    largest dimensions).

The rule is applied to the JAX leaf's shape — stacked blocks (L, ...),
linear weights (in, out) — and mapped onto the port's per-layer (out, in)
tensors (utils/convert.py), so the data axis splits the same dimension as
in the JAX package and a checkpoint's slices are the JAX package's. One
exception: a tp rank's c_attn holds whole heads of q, k and v, which are
three column ranges of the JAX wqkv (JAX splits its 3D columns in one
block and reshards before the head-sharded kernel).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import OmniBioTAConfig
from ..utils.convert import torch_leaf_map
from .mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS

PP_MODES = ("pp", "fsdp+pp")
MODES = ("replicated", "fsdp", "tp", "fsdp+tp", "sp") + PP_MODES


def _tp_spec(key: str, ndim: int) -> Tuple:
    """Megatron TP on a JAX leaf: column-split the fan-out of wqkv and
    mlp wi, row-split the fan-in of both wo, split lm_head's vocab,
    replicate norms, embeddings and biases."""
    name = key.split("/")[-1]
    lead = (None,) if key.startswith("blocks/") else ()
    if name in ("wqkv", "wi"):
        spec = (*lead, None, MODEL_AXIS)
    elif name == "wo":
        spec = (*lead, MODEL_AXIS, None)
    elif name == "lm_head":
        spec = (None, MODEL_AXIS)
    else:
        spec = ()
    return tuple(spec) + (None,) * (ndim - len(spec))


def _fsdp_dim(shape: Sequence[int], n_shards: int) -> Optional[int]:
    """The pipeline's data-split dimension: the first of the largest
    dimensions that divide by n_shards (None: none does)."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if s % n_shards == 0 and s > best_size:
            best, best_size = i, s
    return best


def pp_param_pspecs(shapes: Mapping[str, Tuple[int, ...]],
                    fsdp_shards: int = 1) -> Dict[str, Tuple]:
    """The JAX package's `pp_param_pspecs`: a stacked block leaf's layer
    dimension over 'stage', everything else replicated; with fsdp_shards >
    1 (fsdp+pp) every leaf also split over 'data' on `_fsdp_dim` of its
    dimensions after the layer one."""
    out = {}
    for key, shape in shapes.items():
        lead = 1 if key.startswith("blocks/") else 0
        dims = [STAGE_AXIS] * lead + [None] * (len(shape) - lead)
        if fsdp_shards > 1:
            d = _fsdp_dim(shape[lead:], fsdp_shards)
            if d is not None:
                dims[lead + d] = DATA_AXIS
        out[key] = tuple(dims)
    return out


def param_pspecs(shapes: Mapping[str, Tuple[int, ...]], mode: str,
                 n_data: int, n_model: int) -> Dict[str, Tuple]:
    """{JAX leaf key: spec}, a spec being one mesh axis name or None per
    dimension, for the JAX leaf shapes given: the JAX package's rule."""
    if mode not in MODES:
        raise ValueError(f"sharding {mode!r} is not one of {MODES}")
    if mode in PP_MODES:
        return pp_param_pspecs(shapes, n_data if mode == "fsdp+pp" else 1)
    out = {}
    for key, shape in shapes.items():
        dims = [None] * len(shape)
        if mode in ("tp", "fsdp+tp") and n_model > 1:
            dims = list(_tp_spec(key, len(shape)))
        if mode in ("fsdp", "fsdp+tp") and n_data > 1:
            free = [(shape[i], i) for i, d in enumerate(dims)
                    if d is None and shape[i] % n_data == 0]
            if free and DATA_AXIS not in dims:
                _, dim = max(free)
                dims[dim] = DATA_AXIS
        out[key] = tuple(dims)
    return out


def jax_leaf_shapes(cfg: OmniBioTAConfig) -> Dict[str, Tuple[int, ...]]:
    """The JAX parameter tree's leaf shapes, by flat key."""
    shapes: Dict[str, Tuple[int, ...]] = {}
    for name, (key, layer, transposed, shape) in torch_leaf_map(cfg).items():
        jshape = tuple(reversed(shape)) if transposed else tuple(shape)
        shapes[key] = ((cfg.n_layer,) + jshape) if layer is not None else jshape
    return shapes


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where one named tensor of the port's model lives on the mesh.

    The model split comes first: `model_ranges` are the row (model_dim)
    ranges of the full tensor that this model rank holds, concatenated into
    its model-local tensor (empty: held whole). Then the data split of the
    model-local tensor: `data_dim` cut into n_data equal blocks, or, when
    fsdp splits a stacked leaf's layer axis, the whole tensor held by data
    rank `layer_owner` alone. `model_partial`: held whole, used in part by
    the tp forward (c_attn's and c_fc's biases), so its gradients are
    summed over 'model'. seq_index: this rank's place on a seq axis, which
    holds every tensor whole. `staged`: a block's tensor on a stage axis,
    held by its layer's stage alone (the others hold every stage's copy);
    stage_index: this rank's place on that axis."""
    name: str
    jax_key: str
    layer: Optional[int]
    transposed: bool
    shape: Tuple[int, ...]
    model_dim: Optional[int]
    model_ranges: Tuple[Tuple[int, int], ...]
    model_partial: bool
    data_dim: Optional[int]
    layer_owner: Optional[int]
    n_data: int
    data_index: int
    model_index: int
    seq_index: int = 0
    staged: bool = False
    stage_index: int = 0

    @property
    def data_split(self) -> bool:
        return self.data_dim is not None or self.layer_owner is not None

    @property
    def local_shape(self) -> Tuple[int, ...]:
        """The model-local tensor's shape (the compute copy's)."""
        shape = list(self.shape)
        if self.model_ranges:
            shape[self.model_dim] = sum(b - a for a, b in self.model_ranges)
        return tuple(shape)

    def shard_shape(self, data_rank: int) -> Tuple[int, ...]:
        shape = list(self.local_shape)
        if self.data_dim is not None:
            shape[self.data_dim] //= self.n_data
        elif self.layer_owner is not None and data_rank != self.layer_owner:
            shape[0] = 0
        return tuple(shape)

    def model_local(self, full: torch.Tensor) -> torch.Tensor:
        """This model rank's rows of the full tensor."""
        if not self.model_ranges:
            return full
        return torch.cat([full.narrow(self.model_dim, a, b - a)
                          for a, b in self.model_ranges], dim=self.model_dim)

    def data_piece(self, local: torch.Tensor, data_rank: int) -> torch.Tensor:
        """Data rank `data_rank`'s block of a model-local tensor (a view)."""
        if self.data_dim is not None:
            n = local.shape[self.data_dim] // self.n_data
            return local.narrow(self.data_dim, data_rank * n, n)
        if self.layer_owner is not None and data_rank != self.layer_owner:
            return local.narrow(0, 0, 0)
        return local

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full tensor (a copy)."""
        return self.data_piece(self.model_local(full), self.data_index).clone()

    def writes(self) -> bool:
        """Whether this rank writes its shard to a checkpoint: the one
        replica of it with index 0 on every axis that holds it whole."""
        data_ok = self.data_split or self.data_index == 0
        model_ok = bool(self.model_ranges) or self.model_index == 0
        if self.layer_owner is not None and self.layer_owner != self.data_index:
            return False
        stage_ok = self.staged or self.stage_index == 0
        return data_ok and model_ok and stage_ok and self.seq_index == 0

    def jax_pieces(self, shard: torch.Tensor):
        """[(JAX-layout index, piece)] of this rank's shard within the JAX
        leaf, the piece laid out as the JAX leaf (transposed, with a
        leading layer axis of one for a stacked leaf): one piece a model
        range (c_attn's three), else one."""
        starts, stops = [0] * len(self.shape), list(self.shape)
        if self.data_dim is not None:
            n = self.local_shape[self.data_dim] // self.n_data
            starts[self.data_dim] = self.data_index * n
            stops[self.data_dim] = starts[self.data_dim] + n
        pieces, at = [], 0
        for a, b in self.model_ranges:
            lo, hi = list(starts), list(stops)
            lo[self.model_dim], hi[self.model_dim] = a, b
            pieces.append((lo, hi, shard.narrow(self.model_dim, at, b - a)))
            at += b - a
        out = []
        for lo, hi, piece in pieces or [(starts, stops, shard)]:
            idx = [slice(s, e) for s, e in zip(lo, hi)]
            if self.transposed:
                idx, piece = idx[::-1], piece.t()
            if self.layer is not None:
                idx = [slice(self.layer, self.layer + 1)] + idx
                piece = piece.unsqueeze(0)
            out.append((tuple(idx), piece))
        return out


def stage_layers(n_layer: int, n_stage: int, stage_index: int) -> range:
    """The global indices of stage `stage_index`'s layers: the stage's
    contiguous L/S of them, as the JAX pipeline splits its stacked blocks."""
    if n_layer % n_stage:
        raise ValueError(f"n_layer {n_layer} must divide by {n_stage} pipeline stages")
    per = n_layer // n_stage
    return range(stage_index * per, (stage_index + 1) * per)


def plan_placements(cfg: OmniBioTAConfig, mode: str, n_data: int, n_model: int,
                    data_index: int = 0, model_index: int = 0, seq_index: int = 0,
                    n_stage: int = 1, stage_index: int = 0) -> Dict[str, Placement]:
    """{torch name: Placement} of every parameter of the port's model that
    this rank holds: all of them, but under a pipeline mode only the blocks
    of its stage's layers (and the tensors every stage holds)."""
    specs = param_pspecs(jax_leaf_shapes(cfg), mode, n_data, n_model)
    tp = mode in ("tp", "fsdp+tp") and n_model > 1
    held = stage_layers(cfg.n_layer, n_stage, stage_index)
    D = cfg.n_embd
    out = {}
    for name, (key, layer, transposed, shape) in torch_leaf_map(cfg).items():
        spec = specs[key]
        if layer is not None:
            lead, spec = spec[0], spec[1:]
        else:
            lead = None
        if lead == STAGE_AXIS and layer not in held:
            continue
        if transposed:
            spec = spec[::-1]
        model_dim = spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None
        data_dim = spec.index(DATA_AXIS) if DATA_AXIS in spec else None
        ranges: Tuple[Tuple[int, int], ...] = ()
        leaf = key.split("/")[-1]
        if model_dim is not None:
            if leaf == "wqkv":   # whole heads of q, k and v
                w = D // n_model
                ranges = tuple((s + model_index * w, s + (model_index + 1) * w)
                               for s in (0, D, 2 * D))
            else:
                w = shape[model_dim] // n_model
                ranges = ((model_index * w, (model_index + 1) * w),)
        out[name] = Placement(
            name=name, jax_key=key, layer=layer, transposed=transposed,
            shape=tuple(shape), model_dim=model_dim, model_ranges=ranges,
            model_partial=tp and leaf in ("bqkv", "bi"),
            data_dim=data_dim,
            layer_owner=(layer // (cfg.n_layer // n_data)
                         if lead == DATA_AXIS else None),
            n_data=n_data, data_index=data_index, model_index=model_index,
            seq_index=seq_index, staged=lead == STAGE_AXIS, stage_index=stage_index)
    return out


def shard_params(full: Mapping[str, torch.Tensor],
                 placements: Mapping[str, Placement]) -> Dict[str, torch.Tensor]:
    """This rank's shards of a full {name: tensor} state (of the tensors
    it holds)."""
    return {n: pl.take(full[n]) for n, pl in placements.items()}


def shard_opt_state_like(moments: Mapping[str, torch.Tensor],
                         placements: Mapping[str, Placement]) -> Dict[str, torch.Tensor]:
    """Adam's moments take their parameter's placement, matched by name
    (never by shape or position)."""
    return shard_params(moments, placements)


# ---------------------------------------------------------------------------
# The collectives of a step: gather the compute copy, reduce the gradients
# ---------------------------------------------------------------------------

def _buckets(names: Sequence[str], tensors: Mapping[str, torch.Tensor]):
    """Names grouped by dtype, in order."""
    out: Dict[torch.dtype, List[str]] = {}
    for n in names:
        out.setdefault(tensors[n].dtype, []).append(n)
    return out.values()


def _offsets(names: Sequence[str], placements, n_data: int):
    """Per data rank: ({name: (offset, numel)}, total) of its shards packed
    one after another, and the common total (equal on every rank)."""
    table, totals = [], []
    for r in range(n_data):
        at, row = 0, {}
        for n in names:
            k = math.prod(placements[n].shard_shape(r))
            row[n] = (at, k)
            at += k
        table.append(row)
        totals.append(at)
    if len(set(totals)) != 1:
        raise ValueError(f"data ranks hold unequal shares {totals}")
    return table, totals[0]


def all_gather_data(shards: Mapping[str, torch.Tensor],
                    placements: Mapping[str, Placement], group,
                    n_data: int) -> Dict[str, torch.Tensor]:
    """The model-local tensors of the data-split shards: one flat
    all-gather over 'data' a dtype. Data-replicated tensors pass through."""
    out = {n: t for n, t in shards.items() if not placements[n].data_split}
    for names in _buckets([n for n in shards if placements[n].data_split], shards):
        table, S = _offsets(names, placements, n_data)
        mine = torch.cat([shards[n].reshape(-1) for n in names])
        flat = torch.empty(n_data * S, dtype=mine.dtype, device=mine.device)
        dist.all_gather_into_tensor(flat, mine, group=group)
        for n in names:
            p = placements[n]
            pieces = [flat[r * S + table[r][n][0]:r * S + sum(table[r][n])]
                      .view(p.shard_shape(r)) for r in range(n_data)]
            out[n] = (torch.cat(pieces, dim=p.data_dim) if p.data_dim is not None
                      else pieces[p.layer_owner])
    return out


def _all_reduce_flat(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum each tensor over `group` through one flat buffer."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def reduce_grads(grads: Mapping[str, torch.Tensor],
                 placements: Mapping[str, Placement], data_group, n_data: int,
                 model_group=None) -> Dict[str, torch.Tensor]:
    """Sum the model-local gradients of every rank over the mesh, once per
    step: over 'model' for the tp-sliced biases, then reduce-scatter over
    'data' for the data-split tensors (each rank keeps its shard's sum) and
    all-reduce over 'data' for the rest. The loss is already normalised by
    the global masked count, so a sum is the global gradient."""
    grads = dict(grads)
    partial = [n for n in grads if placements[n].model_partial]
    for names in _buckets(partial, grads):
        grads.update(zip(names, _all_reduce_flat([grads[n] for n in names], model_group)))
    split = [n for n in grads if placements[n].data_split]
    for names in _buckets(split, grads):
        table, S = _offsets(names, placements, n_data)
        send = torch.cat([placements[n].data_piece(grads[n], r).reshape(-1)
                          for r in range(n_data) for n in names])
        mine = torch.empty(S, dtype=send.dtype, device=send.device)
        dist.reduce_scatter_tensor(mine, send, group=data_group)
        r = placements[names[0]].data_index
        for n in names:
            at, k = table[r][n]
            grads[n] = mine[at:at + k].view(placements[n].shard_shape(r))
    whole = [n for n in grads if not placements[n].data_split]
    for names in _buckets(whole, grads):
        grads.update(zip(names, _all_reduce_flat([grads[n] for n in names], data_group)))
    return grads


def norm_weights(names: Sequence[str], placements: Mapping[str, Placement]) -> List[float]:
    """1.0 where this rank's share of a gradient counts towards the global
    norm, 0.0 where another rank holds the same values: the replica a
    checkpoint takes, so each value counts once."""
    return [1.0 if placements[n].writes() else 0.0 for n in names]


class MeshPlan:
    """A rank's view of its mesh under one sharding mode: its data, model
    and seq coordinates and groups, its tensor-parallel place (under 'tp'
    and 'fsdp+tp' on a mesh with a 'model' axis, of any size), its ring
    (under 'sp'), its pipeline stage (under 'pp' and 'fsdp+pp'), the group
    its batch tiles are cut over, and the placement of every named
    parameter it holds."""

    def __init__(self, cfg: OmniBioTAConfig, mode: str, mesh):
        from ..ops.ring_attention import ring_of
        from .mesh import axis_group, axis_index, axis_size
        from .pipeline import Stage
        from .tensor import TensorParallel

        self.mesh, self.mode = mesh, mode
        axes = mesh.mesh_dim_names or ()
        self.stage = None
        if mode in PP_MODES:
            if STAGE_AXIS not in axes:
                raise ValueError(f"sharding={mode!r} needs a mesh with a "
                                 f"'{STAGE_AXIS}' axis, not {axes}")
            self.stage = Stage(axis_group(mesh, STAGE_AXIS), axis_index(mesh, STAGE_AXIS),
                               axis_size(mesh, STAGE_AXIS))
        self.n_data = axis_size(mesh, DATA_AXIS)
        self.data_index = axis_index(mesh, DATA_AXIS)
        self.data_group = axis_group(mesh, DATA_AXIS)
        self.n_seq = axis_size(mesh, SEQ_AXIS)
        self.seq_index = axis_index(mesh, SEQ_AXIS)
        self.ring = None
        if mode == "sp":
            self.ring = ring_of(mesh, SEQ_AXIS, DATA_AXIS if self.n_data > 1 else None)
        # the group over which ranks hold different tiles of the batch: the
        # data axis, or every rank when the sequence is cut too (the mesh
        # spans the process group)
        self.batch_group = dist.group.WORLD if self.n_seq > 1 else self.data_group
        self.tp = None
        if "tp" in mode and MODEL_AXIS in (mesh.mesh_dim_names or ()):
            self.tp = TensorParallel(axis_group(mesh, MODEL_AXIS),
                                     axis_index(mesh, MODEL_AXIS),
                                     axis_size(mesh, MODEL_AXIS))
            if cfg.n_head % self.tp.size:
                raise ValueError(
                    f"sharding={mode!r}: n_head={cfg.n_head} is not divisible "
                    f"by the model axis ({self.tp.size})")
        self.placements = plan_placements(
            cfg, mode, self.n_data, 1 if self.tp is None else self.tp.size,
            self.data_index, 0 if self.tp is None else self.tp.index,
            self.seq_index, 1 if self.stage is None else self.stage.size,
            0 if self.stage is None else self.stage.index)

    def rows(self, local_rows: int) -> Tuple[int, int]:
        """(first, total) of this rank's rows in the global micro-batch."""
        return self.data_index * local_rows, self.n_data * local_rows

    def cols(self, local_len: int) -> Tuple[int, int]:
        """(first, total) of this rank's positions in the whole sequence."""
        return self.seq_index * local_len, self.n_seq * local_len

    def gather(self, shards: Mapping[str, torch.Tensor],
               dtype: Optional[torch.dtype] = None) -> Dict[str, torch.Tensor]:
        """The model-local tensors, the ≥2-D ones cast to `dtype` before
        the all-gather (the step's compute copy: cast and gathered once a
        step); detached."""
        cast = {n: (p.detach().to(dtype) if dtype is not None and p.ndim >= 2
                    else p.detach()) for n, p in shards.items()}
        return all_gather_data(cast, self.placements, self.data_group, self.n_data)

    def reduce(self, grads: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The gradients summed over the mesh (over 'data', and over 'seq'
        where the sequence is cut: `batch_group`). On a stage axis the
        tensors every stage holds are first summed over 'stage' (each stage
        holds the part of their gradient its own work gave), so that every
        stage updates them alike."""
        if self.stage is not None and self.stage.size > 1:
            grads = dict(grads)
            shared = [n for n in grads if not self.placements[n].staged]
            for names in _buckets(shared, grads):
                grads.update(zip(names, _all_reduce_flat([grads[n] for n in names],
                                                         self.stage.group)))
        if self.stage is not None and self.data_group is None:
            return grads    # a ('stage',) mesh: no data axis to sum over
        return reduce_grads(grads, self.placements, self.batch_group, self.n_data,
                            None if self.tp is None else self.tp.group)

    def sum_over_batch(self, *scalars: torch.Tensor) -> List[torch.Tensor]:
        """Each 0-d tensor summed over every axis the batch is cut on (one
        all-reduce over `batch_group`)."""
        flat = torch.stack([s.double() for s in scalars])
        dist.all_reduce(flat, group=self.batch_group)
        return [f.to(s.dtype) for f, s in zip(flat, scalars)]
