"""MLM pretraining loop on one GPU or a mesh of them: gradient
accumulation, the batch ramp, µP AdamW, metrics, checkpoints.

Port of `omnibiote_tpu/training/train.py` (re-design of the reference's
train_encoder.py):
  * the train step runs A accumulation slots with per-slot activity
    weights (the batch ramp varies the number of active slots; shapes stay
    fixed), then one optimizer update;
  * the ≥2-D weights are cast to the compute dtype once per step and the
    gradients are taken with respect to that copy (`_compute_copy`; on a
    mesh `MeshPlan.gather`), as the JAX step does; the fp32 masters stay
    with the optimizer;
  * per-step randomness: slot i of step s draws its MLM mask and dropout
    from the integer seed `slot_seed(seed, s, i)` (the JAX package's
    fold_in(fold_in(rng, s), i)), so a resumed run redraws the same masks
    from `step` alone;
  * metrics (loss, token counts, grad norm) stay device tensors until the
    loop fetches them every log_every steps.

Every single-device mode of the JAX Trainer runs, rematerialisation
(checkpoint_freq > 0, models/omnibiota.py) and the fused cross-entropy
(fused_ce, ops/fused_ce.py) included.

On a mesh (one process a GPU under torchrun, parallel/mesh.py) the sharding
modes 'replicated' (DDP), 'fsdp', 'tp', 'fsdp+tp' and 'sp' run
(parallel/sharding.py): a data rank takes its rows of every global
micro-batch (or, with data_hosts > 1, its own pipeline's rows), draws its
rows of the global MLM masks and divides its loss by the global masked
count; the gradients are reduced once a step after accumulation (fsdp:
the compute copy is all-gathered and the gradients reduce-scattered once a
step), and the metrics are summed over 'data'. Sequence parallelism ('sp',
attn_impl='ring', the JAX Trainer's mesh: the whole mesh the 'seq' axis,
or a 2-D ('data', 'seq') mesh for dp x sp) goes through the same step: a
rank's tile is its rows and its block of positions, its masks that tile of
the global draw, and the gradients and metrics are summed over both axes
(MeshPlan.batch_group). The pipeline ('pp' on a ('stage',) mesh, dp x pp
and 'fsdp+pp' on ('data', 'stage')) has a step of its own
(`make_pp_train_step`): the compute copy of the stage's tensors gathered
once a step, the A slots through the GPipe schedule
(parallel/pipeline.py), the gradients of the tensors every stage holds
summed over 'stage', then the reduction over 'data' and one update.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..config import OmniBioTAConfig, TrainConfig, torch_dtype
from ..models.omnibiota import OmniBioTA, init_params, num_params
from ..utils.device import resolve_device
from .mlm import mlm_loss
from .optim import MupAdamW, OptState, linear_decay, make_optimizer, scaled_lr


def slot_seed(seed: int, step: int, slot: int) -> int:
    """Integer seed of accumulation slot `slot` of step `step`."""
    return int(np.random.SeedSequence([int(seed), int(step), int(slot)])
               .generate_state(1, np.uint64)[0])


def _compute_copy(params: Dict[str, torch.Tensor],
                  model_cfg: OmniBioTAConfig) -> Dict[str, torch.Tensor]:
    """Leaves to differentiate: the ≥2-D weights cast to the compute dtype
    once per step (not once per micro-step), the rest as they are."""
    cdt = model_cfg.cdtype()
    return {n: (p.detach().to(cdt) if p.ndim >= 2 else p.detach()).requires_grad_()
            for n, p in params.items()}


def check_ported(model_cfg: OmniBioTAConfig, train_cfg: TrainConfig,
                 data_hosts: int = 1, mesh=None) -> None:
    """Raise on the training configurations the JAX Trainer refuses:
    sharding='sp' without attn_impl='ring', sp with data_hosts > 1,
    fsdp+pp without a ('data', 'stage') mesh, and data_hosts > 1 on a
    pure-pp mesh. mesh: the Trainer's, if given (else the one
    train_cfg.mesh_shape gives)."""
    from ..parallel.mesh import DATA_AXIS, axis_size

    tc = train_cfg
    if tc.sharding == "sp" and model_cfg.attn_impl != "ring":
        raise ValueError("sharding='sp' requires attn_impl='ring'")
    if tc.sharding == "sp" and data_hosts > 1:
        raise ValueError("data_hosts>1 with sequence sharding is not "
                         "supported (the seq axis would need per-host "
                         "slicing too)")
    if tc.sharding in ("pp", "fsdp+pp"):
        shape = tc.mesh_shape
        has_data = (DATA_AXIS in (mesh.mesh_dim_names or ()) if mesh is not None
                    else shape is not None and len(shape) == 2)
        if tc.sharding == "fsdp+pp" and not has_data:
            raise ValueError("fsdp+pp needs a 2-D mesh_shape (data, stage)")
        n_data = axis_size(mesh, DATA_AXIS) if mesh is not None else (shape[0] if has_data else 1)
        if data_hosts > 1 and n_data == 1:
            raise ValueError("data_hosts>1 needs the batch dim sharded over the data "
                             "axis; a pure-pp mesh replicates the batch — use dp x pp")


def _meta_parameters(model: nn.Module) -> None:
    """Replace a module's parameters by meta tensors of their shapes: the
    sharded step runs it on the compute copy through functional_call, so
    it holds no weights of its own."""
    for mod in model.modules():
        for k, p in mod._parameters.items():
            if p is not None:
                mod._parameters[k] = nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="meta"),
                    requires_grad=False)


def make_train_step(model: OmniBioTA, model_cfg: OmniBioTAConfig,
                    train_cfg: TrainConfig, optimizer: MupAdamW, plan=None):
    """The train step:

      (params, opt_state, tokens (A, B, T), segments (A, B, T),
       micro_weights (A,) host floats, rng (int), step (int), masks=None)
        -> metrics {'loss', 'masked_tokens', 'num_tokens', 'grad_norm'}

    `params` ({name: tensor}, the fp32 masters) and `opt_state` are updated
    in place. micro_weights holds 1.0 for active slots and 0.0 otherwise;
    an inactive slot contributes exactly nothing, so it is not computed.
    masks: explicit (A, B, T) MLM masks instead of the drawn ones (parity
    tests).

    plan: the parallel.sharding.MeshPlan of the rank (None: one device, no
    mesh). On a mesh `params` and the moments are this rank's shards,
    tokens and segments its rows (A, B / n_data, T) of the global
    micro-batches (masks stay global), and the step gathers the compute
    copy, reduces the gradients once after accumulation and sums the
    metrics over 'data'. Under 'sp' tokens and segments are the rank's
    block of positions (A, B / n_data, T / n_seq), and the sums run over
    'data' and 'seq'."""
    deterministic = model_cfg.dropout == 0.0
    gdt = torch_dtype(train_cfg.grad_dtype)
    count_group = None if plan is None else plan.batch_group

    def micro_grad(params_c, tokens, segments, seed, mask):
        loss, aux = mlm_loss(model, tokens, segments, seed,
                             mask_prob=train_cfg.mask_prob,
                             deterministic=deterministic, mask=mask,
                             params=params_c,
                             mask_rows=None if plan is None else plan.rows(tokens.shape[0]),
                             mask_cols=None if plan is None else plan.cols(tokens.shape[1]),
                             count_group=count_group)
        grads = torch.autograd.grad(loss, list(params_c.values()))
        return loss.detach(), aux, grads

    def train_step(params, opt_state: OptState, tokens, segments,
                   micro_weights: Sequence[float], rng: int, step: int,
                   masks=None):
        A = tokens.shape[0]
        weights = [float(w) for w in micro_weights]
        if plan is None:
            params_c = _compute_copy(params, model_cfg)
        else:
            params_c = {n: p.requires_grad_() for n, p in
                        plan.gather(params, model_cfg.cdtype()).items()}
            if masks is not None:
                lo, _ = plan.rows(tokens.shape[1])
                c0, _ = plan.cols(tokens.shape[2])
                masks = masks[:, lo:lo + tokens.shape[1], c0:c0 + tokens.shape[2]]
        names = list(params_c)
        dev = tokens.device
        loss_sum = torch.zeros((), device=dev)
        masked = torch.zeros((), device=dev)
        tokens_seen = torch.zeros((), dtype=torch.int64, device=dev)
        if A == 1:
            # no accumulation buffer; grad_dtype sets the grads' dtype (the
            # weight is 0 or 1, exact in bf16)
            w = weights[0]
            loss, aux, g = micro_grad(params_c, tokens[0], segments[0],
                                      slot_seed(rng, step, 0),
                                      None if masks is None else masks[0])
            grads = [x.to(gdt) * w for x in g]
            loss_sum = loss_sum + w * loss
            masked = masked + w * aux["masked_count"]
            tokens_seen = tokens_seen + (w > 0) * aux["num_tokens"]
        else:
            # accumulating: fp32 adds, rounded to grad_dtype per micro-step
            grads = [torch.zeros(params_c[n].shape, dtype=gdt, device=dev)
                     for n in names]
            for i, w in enumerate(weights):
                if w == 0.0:
                    continue
                loss, aux, g = micro_grad(params_c, tokens[i], segments[i],
                                          slot_seed(rng, step, i),
                                          None if masks is None else masks[i])
                if gdt == torch.float32:
                    torch._foreach_add_(grads, [x.float() for x in g], alpha=w)
                else:
                    grads = [(a.float() + w * x.float()).to(gdt)
                             for a, x in zip(grads, g)]
                loss_sum = loss_sum + w * loss
                masked = masked + w * aux["masked_count"]
                tokens_seen = tokens_seen + aux["num_tokens"]
        n_active = max(sum(weights), 1.0)
        grads = dict(zip(names, grads))
        del params_c
        if plan is not None:
            grads = plan.reduce(grads)
            loss_sum, masked, tokens_seen = plan.sum_over_batch(
                loss_sum, masked, tokens_seen)
        # dtype-preserving divide (bf16 grads stay bf16)
        grads = {n: (g.float() / n_active).to(g.dtype) for n, g in grads.items()}
        optimizer.update(grads, opt_state, params)
        return {"loss": loss_sum / n_active, "masked_tokens": masked,
                "num_tokens": tokens_seen, "grad_norm": opt_state.grad_norm}

    return train_step


def make_pp_train_step(model: OmniBioTA, model_cfg: OmniBioTAConfig,
                       train_cfg: TrainConfig, optimizer: MupAdamW, plan):
    """The pipeline's train step, with make_train_step's signature: the A
    slots go through the GPipe schedule in one pass (the schedule is the
    accumulation: the per-slot gradients of the compute copy sum in its
    `.grad`, as the JAX package's one autodiff sums them), then the
    gradients in fp32 are summed over 'stage' (the tensors every stage
    holds) and 'data', and one update follows. `params` are the stage's
    fp32 masters (its shards under fsdp+pp), tokens and segments the data
    rank's rows; the metrics are summed over the whole mesh."""
    from ..parallel.pipeline import pipeline_step

    deterministic = model_cfg.dropout == 0.0

    def train_step(params, opt_state: OptState, tokens, segments,
                   micro_weights: Sequence[float], rng: int, step: int,
                   masks=None):
        A, B = tokens.shape[:2]
        weights = [float(w) for w in micro_weights]
        params_c = {n: p.requires_grad_() for n, p in
                    plan.gather(params, model_cfg.cdtype()).items()}
        rows = plan.rows(B)
        if masks is not None:
            masks = masks[:, rows[0]:rows[0] + B]
        loss_sum, masked, tokens_seen = pipeline_step(
            model, plan.stage, params_c, tokens, segments, weights,
            [slot_seed(rng, step, j) for j in range(A)], mask_prob=train_cfg.mask_prob,
            deterministic=deterministic, masks=masks, mask_rows=rows,
            data_group=plan.data_group if plan.n_data > 1 else None)
        # a tensor this stage did not use (the head off the readout's
        # stages, the embedding past stage 0) has no gradient here
        grads = {n: (p.grad.float() if p.grad is not None
                     else torch.zeros(p.shape, device=p.device))
                 for n, p in params_c.items()}
        del params_c
        grads = plan.reduce(grads)
        # the metrics over every rank of the mesh (it spans the process group)
        flat = torch.stack([loss_sum.double(), masked.double(), tokens_seen.double()])
        dist.all_reduce(flat)
        loss_sum, masked, tokens_seen = (flat[0].float(), flat[1].float(),
                                         flat[2].to(torch.int64))
        n_active = max(sum(weights), 1.0)
        grads = {n: g / n_active for n, g in grads.items()}
        optimizer.update(grads, opt_state, params)
        return {"loss": loss_sum / n_active, "masked_tokens": masked,
                "num_tokens": tokens_seen, "grad_norm": opt_state.grad_norm}

    return train_step


def make_eval_step(model: OmniBioTA, model_cfg: OmniBioTAConfig,
                   train_cfg: TrainConfig):
    """Validation-loss probe (train_encoder.py:371-410): the same masked
    CE, no dropout, no gradients. params: the tensors to run the model with
    (a sharded trainer's gathered masters), None for its own."""

    @torch.no_grad()
    def eval_step(tokens, segments, rng: int, params=None, cols=None, group=None):
        """cols and group: under a ring, the positions the tokens hold and
        the seq axis's group (the loss is this block's share)."""
        loss, aux = mlm_loss(model, tokens, segments, rng,
                             mask_prob=train_cfg.mask_prob, deterministic=True,
                             params=params, mask_cols=cols, count_group=group)
        return loss, aux["masked_count"]

    return eval_step


def effective_batch_size(step: int, total_iters: int, train_cfg: TrainConfig,
                         global_micro: Optional[int] = None) -> int:
    """Effective batch for this step: the reference's batch ramp
    (train_encoder.py:245-255) in units of the micro-batch."""
    bs = train_cfg.batch_size
    mbs = global_micro or train_cfg.mini_batch_size
    if not train_cfg.batch_ramp:
        return bs
    denom = total_iters * train_cfg.warmup_period
    if denom <= 0:   # warmup_period=0 / tiny budget: ramp already complete
        return bs
    ramp = int(step / denom * bs)
    eff = min((ramp // mbs) * mbs + mbs, bs)
    return (eff // mbs) * mbs


def choose_mesh(train_cfg: TrainConfig, device=None):
    """The JAX Trainer's mesh choice over the process group (started if
    needed): for 'sp' the whole mesh on 'seq' (a 1-D mesh_shape or none),
    or a 2-D mesh_shape over ('data', 'seq'); for the pipeline the whole
    mesh on 'stage', or a 2-D mesh_shape over ('data', 'stage'); else
    mesh_shape over ('data', 'model'), else every rank on
    'model' for a tp mode, else every rank on 'data'."""
    from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, SEQ_AXIS, STAGE_AXIS,
                                 init_distributed, make_mesh)

    init_distributed(device)
    shape = train_cfg.mesh_shape
    for modes, axis in ((("sp",), SEQ_AXIS), (("pp", "fsdp+pp"), STAGE_AXIS)):
        if train_cfg.sharding in modes:
            if shape is not None and len(shape) == 2:
                return make_mesh(tuple(shape), (DATA_AXIS, axis), device)
            return make_mesh((dist.get_world_size() if shape is None else shape[0],),
                             (axis,), device)
    if train_cfg.mesh_shape is not None:
        return make_mesh(tuple(train_cfg.mesh_shape),
                         (DATA_AXIS, MODEL_AXIS)[:len(train_cfg.mesh_shape)], device)
    if "tp" in train_cfg.sharding:
        return make_mesh((1, dist.get_world_size()), (DATA_AXIS, MODEL_AXIS), device)
    return make_mesh(None, device=device)


class Trainer:
    """End-to-end MLM pretraining driver on one device (None: the GPU) or a
    mesh of ranks.

    Owns the model (fp32 master parameters, or this rank's shards of them),
    the optimizer state, the data stream and its staging, checkpoints and
    metrics.

    The Trainer runs sharded when given a mesh (parallel.mesh.make_mesh),
    when train_cfg asks for a sharding other than 'replicated' or for a
    mesh_shape, when data_hosts > 1, or inside a process group of more than
    one rank; it then builds the JAX Trainer's mesh over the group
    (starting a group of one if none exists). data_hosts > 1: batch_iter
    yields only this data rank's rows (a pipeline built with num_hosts =
    data_hosts, host_id = the data index); data_hosts must equal the
    data-axis size. Under 'sp' a micro-batch is mini_batch_size rows a
    data rank (the whole mesh's with a 1-D mesh, as in the JAX Trainer),
    each rank holding its block of their positions."""

    def __init__(self, model_cfg: OmniBioTAConfig, train_cfg: TrainConfig,
                 batch_iter=None, reader_states=None, metrics_sink=None,
                 prefetch: int = 0, data_hosts: int = 1, device=None,
                 init_seed: Optional[int] = None, mesh=None):
        from ..parallel.mesh import mesh_device
        from ..parallel.sharding import MeshPlan, norm_weights, shard_params

        check_ported(model_cfg, train_cfg, data_hosts, mesh)
        tc = train_cfg
        sharded = (mesh is not None or tc.sharding != "replicated"
                   or tc.mesh_shape is not None or data_hosts > 1
                   or (dist.is_initialized() and dist.get_world_size() > 1))
        if sharded and mesh is None:
            mesh = choose_mesh(tc, device)
        self.mesh = mesh
        self.plan = MeshPlan(model_cfg, tc.sharding, mesh) if sharded else None
        self.device = mesh_device(mesh) if sharded else resolve_device(device)
        self.model_cfg = model_cfg
        self.train_cfg = tc
        self.data_hosts = data_hosts
        n_data = 1 if self.plan is None else self.plan.n_data
        self.global_micro = tc.mini_batch_size * n_data
        if tc.batch_size % self.global_micro:
            raise ValueError(f"batch_size {tc.batch_size} must divide by "
                             f"mini_batch_size * n_data = {self.global_micro}")
        if data_hosts > 1 and data_hosts != n_data:
            raise ValueError(
                f"data_hosts={data_hosts} must equal the data-axis size "
                f"({n_data}): each data rank feeds exactly its own rows")
        self.accum_slots = tc.batch_size // self.global_micro
        self.total_iters = int(tc.token_budget / (tc.batch_size * tc.ctx_len))

        # the JAX Trainer's split(key(seed)) -> (training stream, init key)
        seed = tc.seed if init_seed is None else init_seed
        words = np.random.SeedSequence(int(seed)).generate_state(2, np.uint64)
        self.rng = int(words[0])
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(words[1]) & 0x7FFFFFFFFFFFFFFF)
        self.model = init_params(gen, model_cfg, device=self.device)
        self.n_params_non_embedding = num_params(self.model, non_embedding=True)
        self.params = dict(self.model.named_parameters())
        weights = None
        if sharded:
            # every rank draws the full model from the seed, keeps its shards
            # and runs a model of its own local shapes on the compute copy
            full = {n: p.detach() for n, p in self.params.items()}
            self.params = shard_params(full, self.plan.placements)
            del full
            self.model = OmniBioTA(model_cfg, device=self.device, tp=self.plan.tp,
                                   data_index=self.plan.data_index,
                                   ring=self.plan.ring)
            _meta_parameters(self.model)
            weights = norm_weights(list(self.params), self.plan.placements)
        self.optimizer = make_optimizer(list(self.params), model_cfg, tc,
                                        self.total_iters, weights)
        self.opt_state = self.optimizer.init(self.params)
        step_fn = (make_pp_train_step if self.plan is not None
                   and self.plan.stage is not None else make_train_step)
        self._train_step = step_fn(self.model, model_cfg, tc, self.optimizer, self.plan)
        self._eval_step = make_eval_step(self.model, model_cfg, tc)
        self._eval_n = 0

        self.step = 0
        self.trained_tokens = 0
        self.batch_iter = batch_iter
        self.reader_states = reader_states or []
        # step -> copy of reader_states taken before that step's batch was
        # staged: a checkpoint records the position the next step will
        # consume even when prefetch runs ahead. _snap_lock serialises the
        # prefetch thread's snapshot + stage against a checkpoint's read.
        self._reader_snapshots: Dict[int, list] = {}
        self._snap_lock = threading.Lock()
        self.metrics_sink = metrics_sink
        self.prefetch = prefetch
        self._staged = None
        self._grand: Optional[np.ndarray] = None
        self._grand_seg: Optional[np.ndarray] = None
        self._ckpt_thread = None
        self._last_ckpt_path = None

    # -- data staging ------------------------------------------------------

    def _next_rows(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        """n rows (tokens, segments) from the stream, buffering like the
        reference's grand_batch (train_encoder.py:258-268)."""
        toks = [] if self._grand is None else [self._grand]
        segs = [] if self._grand_seg is None else [self._grand_seg]
        have = 0 if self._grand is None else len(self._grand)
        while have < n:
            b = next(self.batch_iter)
            toks.append(np.asarray(b["tokens"]))
            segs.append(np.asarray(b["segments"]))
            have += len(b["tokens"])
        toks = np.concatenate(toks) if len(toks) > 1 else toks[0]
        segs = np.concatenate(segs) if len(segs) > 1 else segs[0]
        self._grand, self._grand_seg = toks[n:], segs[n:]
        return toks[:n], segs[:n]

    def _stage(self, eff_bs: int):
        """One step's input on the host: ({'tokens', 'segments'} (A,
        micro, T) int32, activity weights as a list of floats). On a mesh,
        micro is this data rank's rows of the global micro-batch: cut from
        the global rows, or, with data_hosts > 1, all that this rank's own
        pipeline supplies; with a seq axis, T is the rank's block of
        positions."""
        from ..parallel.mesh import shard_batch_pytree

        A, micro = self.accum_slots, self.global_micro
        active = eff_bs // micro
        hosts = self.data_hosts
        micro_l = micro // hosts
        rows, seg_rows = self._next_rows(eff_bs // hosts)
        T = rows.shape[1]
        tokens = np.zeros((A, micro_l, T), np.int32)
        segments = np.zeros((A, micro_l, T), np.int32)
        tokens[:active] = rows.reshape(active, micro_l, T)
        segments[:active] = seg_rows.reshape(active, micro_l, T)
        if active < A:  # inactive slots: repeat slot 0, weight 0
            tokens[active:] = tokens[0]
            segments[active:] = segments[0]
        weights = [1.0] * active + [0.0] * (A - active)
        batch = {"tokens": tokens, "segments": segments}
        if hosts == 1 and self.plan is not None:
            seq_dim = 2 if self.plan.n_seq > 1 else None
            batch = {k: np.ascontiguousarray(v) for k, v in shard_batch_pytree(
                self.mesh, batch, batch_dim=1, seq_dim=seq_dim).items()}
        return batch, weights

    def _staged_stream(self):
        """Staged step inputs, the step count kept in lockstep with
        train_step_once so the batch ramp is computed for the step that
        consumes each batch (this lets the prefetch thread run ahead)."""
        step = self.step
        while True:
            with self._snap_lock:
                if self.reader_states:
                    self._reader_snapshots[step] = [
                        s.copy() for s in self.reader_states]
                    for k in [k for k in self._reader_snapshots if k < self.step]:
                        del self._reader_snapshots[k]
                eff = effective_batch_size(step, self.total_iters,
                                           self.train_cfg, self.global_micro)
                staged = self._stage(eff)
            yield staged
            step += 1

    def _staged_iter(self):
        if self._staged is None:
            stream = self._staged_stream()
            if self.prefetch > 0:
                from ..data.prefetch import DevicePrefetcher
                stream = DevicePrefetcher(stream, device=self.device,
                                          depth=self.prefetch)
            self._staged = stream
        return self._staged

    def reader_states_for_checkpoint(self):
        """Stream position for the next step to train: the snapshot taken
        before that step's batch was staged, or a copy of the live states
        when nothing has been staged ahead."""
        with self._snap_lock:
            snap = self._reader_snapshots.get(self.step)
            if snap is not None:
                return snap
            return [s.copy() for s in self.reader_states]

    def close(self):
        """Stop the prefetch thread (if any) and join an in-flight
        checkpoint write."""
        if self._staged is not None and hasattr(self._staged, "close"):
            self._staged.close()
        self._staged = None
        self.wait_for_checkpoint()

    def wait_for_checkpoint(self):
        """Join the last background checkpoint write, re-raising its
        failure."""
        t = self._ckpt_thread
        if t is not None:
            t.join()
            self._ckpt_thread = None
            if t.exc is not None:
                raise RuntimeError("async checkpoint write failed") from t.exc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- main loop ---------------------------------------------------------

    def train_step_once(self):
        batch, weights = next(self._staged_iter())
        tokens = torch.as_tensor(batch["tokens"]).to(self.device)
        segments = torch.as_tensor(batch["segments"]).to(self.device)
        metrics = self._train_step(self.params, self.opt_state, tokens,
                                   segments, weights, self.rng, self.step)
        self.step += 1
        return metrics

    def step_memory_analysis(self) -> dict:
        """Peak device memory the process has allocated so far
        (torch.cuda.max_memory_allocated); reset it with
        torch.cuda.reset_peak_memory_stats before the steps of interest."""
        if self.device.type != "cuda":
            raise RuntimeError("device memory is measured on a CUDA device")
        return {"peak_allocated_bytes": torch.cuda.max_memory_allocated(self.device)}

    def profile(self, n_steps: int = 3, trace_dir: str = "obt_profile") -> str:
        """A torch.profiler trace (CPU and CUDA activities) of n_steps train
        steps after one warm-up step, written to trace_dir/trace.json."""
        import os

        from torch.profiler import ProfilerActivity, profile
        self.train_step_once()
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        with profile(activities=activities) as prof:
            for _ in range(n_steps):
                m = self.train_step_once()
            float(m["loss"])
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        return trace_dir

    def run(self, max_steps: Optional[int] = None, on_metrics=None,
            val_iters: Optional[dict] = None):
        """Main loop. val_iters: {corpus_name: batch_iterator} probed every
        test_freq tokens (train_encoder.py:371-410)."""
        from .metrics import flops_per_token, mfu

        tc = self.train_cfg
        sched = linear_decay(scaled_lr(tc), self.total_iters)
        fpt = flops_per_token(self.n_params_non_embedding,
                              self.model_cfg.n_layer, self.model_cfg.n_embd,
                              tc.ctx_len)
        last_save = last_test = self.trained_tokens
        end_step = self.total_iters if max_steps is None else min(
            self.total_iters, self.step + max_steps)
        tok_base = self.trained_tokens
        tok_dev = None
        last_fetch_t = time.time()
        last_fetch_tok = self.trained_tokens
        first_step = True
        while self.step < end_step:
            t0 = time.time()
            step_idx = self.step
            metrics = self.train_step_once()
            tok_dev = (metrics["num_tokens"] if tok_dev is None
                       else tok_dev + metrics["num_tokens"])
            # a fetch waits for the device: only every log_every steps
            fetch = (first_step or step_idx % tc.log_every == 0 or
                     self.step >= end_step)
            if fetch:
                loss = float(metrics["loss"])
                self.trained_tokens = tok_base + int(tok_dev)
                tok_base, tok_dev = self.trained_tokens, None
                now = time.time()
                tps = ((self.trained_tokens - last_fetch_tok)
                       / max(now - last_fetch_t, 1e-9))
                rec = {
                    "step": step_idx,
                    "loss": loss,
                    "lr": sched(step_idx),
                    "tokens": self.trained_tokens,
                    "tokens_per_sec": tps,
                    "flops_per_token": fpt,
                    "mfu": mfu(tps, fpt),
                    "step_time_s": now - t0,
                    "grad_norm": float(metrics["grad_norm"]),
                }
                if first_step:
                    # the first step builds kernels and warms the
                    # allocator: report it apart from the throughput
                    first_step = False
                    rec["first_step_time_s"] = now - t0
                    del rec["tokens_per_sec"], rec["mfu"]
                last_fetch_t, last_fetch_tok = now, self.trained_tokens
                if self.metrics_sink is not None:
                    self.metrics_sink.log(rec)
                if on_metrics is not None:
                    on_metrics(rec)
            if val_iters and (self.trained_tokens - last_test) > tc.test_freq:
                for name, it in val_iters.items():
                    vb = next(it)
                    vloss = self.eval_loss(vb["tokens"], vb["segments"])
                    vrec = {"step": step_idx, "tokens": self.trained_tokens,
                            f"test_loss/{name}": vloss}
                    if self.metrics_sink is not None:
                        self.metrics_sink.log(vrec)
                    if on_metrics is not None:
                        on_metrics(vrec)
                last_test = self.trained_tokens
            if (self.trained_tokens - last_save) > tc.save_freq:
                self.save_checkpoint()
                last_save = self.trained_tokens
        return self.trained_tokens

    # -- eval probe --------------------------------------------------------

    def eval_loss(self, tokens, segments) -> float:
        """Validation loss; its masks come from a stream of its own, so
        probes never shift the training stream. On a mesh every rank
        evaluates the whole batch with the gathered fp32 masters; under
        'sp' through the ring, each rank its block of positions; under the
        pipeline through the schedule's forward, each stage its layers."""
        seed = int(np.random.SeedSequence([self.rng, 0x0E7A1, self._eval_n])
                   .generate_state(1, np.uint64)[0])
        self._eval_n += 1
        params = None if self.plan is None else self.plan.gather(self.params)
        tokens, segments = (torch.as_tensor(np.asarray(x)).to(self.device)
                            for x in (tokens, segments))
        if self.plan is not None and self.plan.stage is not None:
            from ..parallel.pipeline import pipeline_step
            stage = self.plan.stage
            with torch.no_grad():
                loss, _, _ = pipeline_step(self.model, stage, params, tokens[None],
                                           segments[None], [1.0], [seed],
                                           mask_prob=self.train_cfg.mask_prob,
                                           deterministic=True, backward=False)
            if stage.size > 1:   # the last stage's readout to every stage
                dist.all_reduce(loss, group=stage.group)
            return float(loss)
        if self.plan is None or self.plan.n_seq == 1:
            return float(self._eval_step(tokens, segments, seed, params)[0])
        # every data rank takes all the rows, each seq rank its positions
        first, total = self.plan.cols(tokens.shape[1] // self.plan.n_seq)
        cut = slice(first, first + total // self.plan.n_seq)
        group = self.plan.ring.group
        loss, _ = self._eval_step(tokens[:, cut], segments[:, cut], seed, params,
                                  cols=(first, total), group=group)
        dist.all_reduce(loss, group=group)
        return float(loss)

    # -- checkpointing -----------------------------------------------------

    def save_checkpoint(self, final: bool = False) -> str:
        from .checkpoint import save_checkpoint
        return save_checkpoint(
            self, final=final,
            async_save=self.train_cfg.async_checkpoint and not final)

    def restore_checkpoint(self, path: str) -> None:
        from .checkpoint import restore_into_trainer
        restore_into_trainer(self, path)
