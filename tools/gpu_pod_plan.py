#!/usr/bin/env python3
"""Pod planner for the PyTorch port on H100 nodes: memory a rank,
collectives a step, pipeline bubble, roofline projection.

The port runs dp, fsdp, tp, pp and sp over torch.distributed, but a chip
call reaches one H100, so no collective across cards can be measured
there. This tool is the port's counterpart of tools/pod_plan.py: given a
model, a sharding mode and a mesh, it prints one JSON object with

  * memory_bytes: one rank's peak device memory, read term by term from
    the port's code (not the JAX formula): the fp32 masters, Adam's moments
    (moment_dtype), the bf16 compute copy made once a step (gathered whole
    under fsdp), the gradients as the port holds them (the plain step's
    autograd gradients of the compute copy, its accumulators and their fp32
    copies; the pp step's bf16 `.grad` sums and their fp32 copies), the
    optimizer's foreach temporaries, and the activations that the blocks
    save for the backward (fp32 LayerNorm and erf-GELU, the dropout masks,
    what the flash autograd Function keeps; remat off, 'full' and 'dots';
    under pp the GPipe schedule's slots) with the MLM head (the compacted
    0.25·T slots, the plain log-softmax or ops/fused_ce.py's chunks). The
    step passes through several high points (a micro-batch's backward, the
    gradient accumulation, the reduction, the optimizer update); `phases`
    gives each, `total` the highest, `peak_at` its name, and `fits`
    compares it with the card's memory;
  * collectives_bytes: the bytes one rank sends a step for each of the
    port's collectives (DDP's gradient all-reduce, fsdp's all-gather and
    reduce-scatter over flat buffers, tp's Megatron all-reduces, pp's P2P
    activations and cotangents, sp's k/v rotation and ids all-gather, the
    clip norm's all-reduce), with NCCL's ring factors 2(n − 1)/n and
    (n − 1)/n, each timed over the link its group crosses: NVLink within
    a node of --gpus-per-node GPUs, InfiniBand across nodes;
  * flops, times_s and projection: the step's compute time at the card's
    measured utilization (default 0.1814, the port's MFU on one H100 at
    omnibiote-small, ctx 1024), stretched by the pipeline bubble
    (S − 1)/(M + S − 1), and step_s = max(compute, collectives). Every time
    is an ESTIMATE: no collective across cards has been measured, and
    overlap of collectives with compute is not modelled.

Hardware figures are the H100 SXM data sheet's (table `HW`); flags override
each. On a machine with a CUDA device the card's own memory
(torch.cuda.get_device_properties(0).total_memory) sets the capacity.

Usage (the CPU needs no flag: nothing is allocated, the model is built on
torch's meta device):
  python3 tools/gpu_pod_plan.py --preset omnibiote-small --chips 8 \\
      --sharding fsdp --ctx 2048 --mini 8 --accum 16
  python3 tools/gpu_pod_plan.py --layers 16 --embd 2048 --heads 16 --ctx 1024 \\
      --chips 16 --sharding fsdp+tp --mesh 2 8 --mini 8 --accum 2 \\
      --moment-dtype bfloat16 --grad-dtype bfloat16 --remat 1
"""
import argparse
import json
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# One H100 SXM (NVIDIA H100 Tensor Core GPU data sheet): bf16 dense
# tensor-core peak, HBM3 size, NVLink 4 (900 GB/s a GPU both ways, 450 GB/s
# a direction) within a node, one 400 Gb/s InfiniBand NDR port a GPU across
# nodes (50 GB/s a direction).
HW = {
    "h100-sxm": dict(peak=989e12, hbm=80e9, nvlink_gbs=450.0, ib_gbs=50.0,
                     source="NVIDIA H100 SXM data sheet"),
}
# The port's training MFU on one H100 80GB HBM3 at 700 W: omnibiote-small,
# ctx 1024, 16 x 2, remat off (chip_smoke.py phase 13).
MEASURED_UTIL = 0.1814
# Headroom for the CUDA context and the caching allocator's fragmentation.
FIT_FRACTION = 0.92

DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}
MODES = ("replicated", "fsdp", "tp", "fsdp+tp", "sp", "pp", "fsdp+pp")


def count_params(cfg):
    """Exact parameter counts of the port's OmniBioTA, built on the meta
    device (nothing is allocated): total, non_embedding (all but wte),
    wte, blocks and other (ln_f and the head), as tools/pod_plan.py counts
    the JAX tree."""
    from omnibiote_tpu_torch.models.omnibiota import OmniBioTA

    model = OmniBioTA(cfg, device="meta")
    total = sum(p.numel() for p in model.parameters())
    wte = model.transformer.wte.weight.numel()
    blocks = sum(p.numel() for p in model.transformer.h.parameters())
    return dict(total=total, non_embedding=total - wte, wte=wte, blocks=blocks,
                other=total - wte - blocks)


def degrees(sharding, chips, mesh):
    """(n_dp, n_tp, n_sp, n_pp) of a mode on `chips` GPUs, with the
    Trainer's mesh choice (training/train.py::choose_mesh): a 2-D mesh is
    (data, model / seq / stage), a 1-D one or none puts every rank on the
    mode's own axis (tp on 'model', sp on 'seq', pp on 'stage', the rest
    on 'data')."""
    if sharding not in MODES:
        raise ValueError(f"sharding {sharding!r} is not one of {MODES}")
    mesh = tuple(mesh) if mesh else None
    if sharding == "fsdp+pp" and (mesh is None or len(mesh) != 2):
        raise ValueError("fsdp+pp needs a 2-D mesh (data, stage), as the Trainer does")
    if mesh is not None and len(mesh) == 2:
        first, second = mesh
    elif sharding in ("replicated", "fsdp"):
        first, second = (mesh[0] if mesh else chips), 1
    else:
        first, second = 1, (mesh[0] if mesh else chips)
    n = dict(dp=first, tp=1, sp=1, pp=1)
    if sharding in ("tp", "fsdp+tp"):
        n["tp"] = second
    elif sharding == "sp":
        n["sp"] = second
    elif sharding in ("pp", "fsdp+pp"):
        n["pp"] = second
    elif second != 1:
        raise ValueError(f"{sharding} takes a 1-D mesh or (data, 1), not {mesh}")
    if first * second != chips:
        raise ValueError(f"mesh {mesh} does not hold {chips} GPUs")
    return n["dp"], n["tp"], n["sp"], n["pp"]


def held_tensors(cfg, sharding, n_dp, n_tp, n_pp):
    """The element counts one rank holds, from the port's own placements
    (parallel/sharding.py::plan_placements, data, model and stage index 0):
    its shards ('shard': the masters and moments) and their model-local
    tensors ('local': the compute copy and the gradients), each split into
    the ≥2-D weights (cast to the compute dtype) and the 1-D ones (kept in
    fp32), with the data-split part of each ('split') and the tensors every
    pipeline stage holds ('shared')."""
    from omnibiote_tpu_torch.parallel.sharding import plan_placements

    pls = plan_placements(cfg, sharding, n_dp, n_tp, n_stage=n_pp)
    out = {k: 0 for k in ("shard2", "shard1", "local2", "local1", "split_local2",
                          "split_local1", "split_shard2", "split_shard1",
                          "shared", "lm_head_local", "largest_shard")}
    for name, pl in pls.items():
        nd = "2" if len(pl.shape) >= 2 else "1"
        local = math.prod(pl.local_shape)
        shard = math.prod(pl.shard_shape(0))
        out["local" + nd] += local
        out["shard" + nd] += shard
        out["largest_shard"] = max(out["largest_shard"], shard)
        if pl.data_split:
            out["split_local" + nd] += local
            out["split_shard" + nd] += shard
        if not pl.staged:
            out["shared"] += local
        if name == "lm_head.weight":
            out["lm_head_local"] = local
    out["layers"] = cfg.n_layer // n_pp
    return out


def head_slots(rows, T_l):
    """The compacted MLM head's slots in a micro-batch of `rows` rows of T_l
    positions at the Trainer's mask rate 0.15 (training/mlm.py: capacity
    max(T_l·capacity_frac, 8) a row)."""
    from omnibiote_tpu_torch.training.mlm import _default_capacity_frac

    return rows * max(int(T_l * _default_capacity_frac(0.15)), 8)


def layer_bytes_per_token(cfg, n_tp=1, ring=1):
    """Bytes a block saves for the backward a token, remat off, from
    models/omnibiota.py::Block.forward (erf-GELU): each LayerNorm keeps
    three fp32 (N, D) tensors (xf − mu for the square, xf − mu again for the
    product, the normalised y for the weight product); the c_attn and c_fc
    inputs (the LayerNorms' outputs, compute dtype); the flash autograd
    Function's pre-RoPE q, k, v (contiguous copies), o and lse2 (fp32, a
    head); the GELU's fp32 erf input and both factors of its product over
    the 4D/M block, and its output (the c_proj input); a bool mask a
    residual dropout. `ring` > 1: the ring's flash body keeps, besides q,
    each rotation's k, v, o and o in fp32, and the combine's fp32 sum."""
    D, cb = cfg.n_embd, DTYPE_BYTES[cfg.compute_dtype]
    H_l, Dl = cfg.n_head // n_tp, D // n_tp
    drop = 1 if cfg.dropout > 0 else 0
    ln = 3 * 4 * D
    attn = 4 * cb * Dl + 4 * H_l
    if ring > 1:
        attn = cb * Dl + ring * (3 * cb * Dl + 4 * Dl + 4 * H_l) + 4 * Dl
    gelu = 3 * 4 * 4 * Dl + cb * 4 * Dl
    return 2 * ln + 2 * cb * D + attn + gelu + 2 * drop * D


def dots_bytes_per_token(cfg, n_tp=1):
    """'dots': a block keeps the outputs of its four unbatched products
    (c_attn, attention c_proj, c_fc, MLP c_proj)."""
    D, cb = cfg.n_embd, DTYPE_BYTES[cfg.compute_dtype]
    Dl = D // n_tp
    return cb * (3 * Dl + D + 4 * Dl + D)


def activation_bytes(cfg, rows, T_l, *, n_tp=1, ring=1):
    """What one micro-batch of `rows` x `T_l` positions keeps for the
    backward on one rank, by part (bytes):

      layer: one block, remat off (layer_bytes_per_token x tokens plus the
        c_attn weight's RoPE-permuted copy, compute dtype);
      layer_kept: one block under cfg's remat (its input for 'full'; its
        input and four product outputs for 'dots'; `layer` without remat);
      embed: the embedding's dropout mask, its int64 ids and the int32
        segment ids every layer's attention shares;
      ln_f: the final LayerNorm's three fp32 tensors and its output, which
        the head's gather keeps;
      head: the head's saved tensors (the plain head's fp32 log-softmax, or
        the fused CE's input and lse);
      head_bwd: what the head's backward adds (the plain head: the
        log-softmax's gradient and its input's, fp32; the fused CE: its
        fp32 dW chunks, their concatenation and cast, the last chunk's
        logits and probabilities);
      block_bwd: what a block's backward adds at its high point (the GELU
        product's fp32 gradient and both factors' gradients)."""
    D, V, cb = cfg.n_embd, cfg.vocab_size, DTYPE_BYTES[cfg.compute_dtype]
    Dl, V_l = D // n_tp, V // n_tp
    N = rows * T_l
    Ns = head_slots(rows, T_l)
    perm = 0 if cfg.qkv_prepermuted else cb * 3 * Dl * D
    layer = layer_bytes_per_token(cfg, n_tp, ring) * N + perm
    if cfg.checkpoint_freq > 0:
        kept = cb * D * N
        if cfg.remat_policy == "dots":
            kept += dots_bytes_per_token(cfg, n_tp) * N
    else:
        kept = layer
    drop = 1 if cfg.dropout > 0 else 0
    embed = drop * D * N + 8 * N + 4 * N
    ln_f = 3 * 4 * D * N + cb * D * N
    fused = n_tp > 1 or cfg.fused_ce
    if fused:
        from omnibiote_tpu_torch.ops.fused_ce import pick_chunks
        chunks = pick_chunks(V_l) if cfg.fused_ce else 1
        Vc = V_l // chunks
        head = cb * D * Ns + 4 * Ns
        head_bwd = (4 * V_l * D + 4 * V_l * D + cb * V_l * D
                    + 4 * Ns * Vc + 4 * Ns * Vc + cb * Ns * Vc + 4 * Ns * D)
    else:
        head = cb * D * Ns + 4 * V * Ns
        head_bwd = 4 * V * Ns + 4 * V * Ns
    block_bwd = 3 * 4 * 4 * Dl * N
    return dict(tokens=N, slots=Ns, layer=layer, layer_kept=kept, embed=embed,
                ln_f=ln_f, head=head, head_bwd=head_bwd, block_bwd=block_bwd)


def memory(cfg, sharding, n_dp, n_tp, n_sp, n_pp, *, mini, accum, ctx,
           moment_dtype="float32", grad_dtype="float32", two_d=False, capacity=None):
    """One rank's device memory at each high point of a train step (bytes),
    following training/train.py (make_train_step, make_pp_train_step),
    training/optim.py and parallel/{sharding,pipeline}.py. two_d: the mesh
    is 2-D (a pipeline then has a data group to reduce over)."""
    t = held_tensors(cfg, sharding, n_dp, n_tp, n_pp)
    cb = DTYPE_BYTES[cfg.compute_dtype]
    mb = DTYPE_BYTES[moment_dtype]
    pp = sharding in ("pp", "fsdp+pp")
    gb = 4 if pp else DTYPE_BYTES[grad_dtype]
    P_s, P_l = t["shard2"] + t["shard1"], t["local2"] + t["local1"]
    split_s = t["split_shard2"] + t["split_shard1"]
    N = mini * (ctx // n_sp)
    xb = cb * cfg.n_embd * N                 # one (rows, T_l, D) activation
    a = activation_bytes(cfg, mini, ctx // n_sp, n_tp=n_tp, ring=n_sp)
    remat = cfg.checkpoint_freq > 0
    dots = remat and cfg.remat_policy == "dots"
    plan_step = sharding != "replicated" or n_dp * n_tp * n_sp * n_pp > 1

    master = 4 * P_s
    moments = 2 * mb * P_s
    persist = master + moments
    # the compute copy: the ≥2-D weights cast once a step; a 1-D tensor is
    # its fp32 master, unless fsdp split it (then gathered, in fp32)
    copy = cb * t["local2"] + 4 * t["split_local1"]
    # the gradients autograd returns for the compute copy (the pp step sums
    # them in its .grad)
    autograd_grads = cb * t["local2"] + 4 * t["local1"]
    grads_l, grads_s = gb * P_l, gb * P_s
    ph = {}
    # the gather: the shards' casts, their flat concatenation, the gathered
    # flat buffer and the tensors cut from it
    ph["gather"] = persist + copy + 2 * cb * t["split_shard2"] + cb * t["split_local2"]

    head_pt = lambda held, own: held + own * (a["ln_f"] + a["head"]) + a["head_bwd"]
    head_grad = cb * t["lm_head_local"]
    if pp:
        # GPipe: every active slot's activations, its input and its output
        # stay until its backward; remat keeps a stage's slice as one
        # checkpoint (its input; 'dots' also the slice's products)
        M, S, L_s = accum, n_pp, t["layers"]
        balance = S > 1 and M % S == 0
        if not remat:
            slice_kept = L_s * a["layer"]
        elif dots:
            slice_kept = L_s * dots_bytes_per_token(cfg, n_tp) * N
        else:
            slice_kept = 0
        held = M * (2 * xb + slice_kept + a["embed"]) + (M * xb if balance else 0)
        head = head_pt(held, M // S if balance else M)
        top = held + a["block_bwd"] + head_grad + (L_s * a["layer"] if remat else 0)
        act = max(head, top)
        ph["micro_batches"] = persist + copy + act
        # fp32 copies of the .grad sums (the 1-D ones are fp32 already)
        ph["grad_copy"] = persist + copy + autograd_grads + 4 * t["local2"]
        last_grads = 0
        # the stage group's flat all-reduce of the tensors every stage
        # holds, and the data group's (see below)
        flat = (4 * t["shared"] if S > 1 else 0) + (grads_l + gb * split_s if two_d else 0)
        if flat:
            ph["reduce"] = persist + grads_l + flat
    else:
        acc = grads_l if accum > 1 else 0
        prev = autograd_grads if accum > 1 else 0
        held = cfg.n_layer * a["layer_kept"] + a["embed"]
        head = head_pt(held, 1)
        top = held + a["block_bwd"] + head_grad + (a["layer"] if remat else 0)
        act = max(head, top)
        ph["micro_batches"] = persist + copy + acc + prev + act
        if accum > 1:
            # fp32: the gradients' fp32 copies before the foreach add; bf16:
            # the rounded sums built beside the old ones
            extra = 4 * t["local2"] if gb == 4 else gb * P_l
            ph["accumulate"] = persist + copy + acc + autograd_grads + extra
        last_grads = autograd_grads      # the last micro-batch's, still bound
        if plan_step:
            # one flat buffer a dtype: the all-reduce copies the whole
            # tensors, the reduce-scatter sends the split ones (a copy) and
            # keeps its shard
            ph["reduce"] = persist + last_grads + 2 * grads_l + gb * split_s
    # the gradients divided by the active slots beside the old ones (bf16:
    # two fp32 temporaries of the largest one as well)
    ph["scale"] = persist + last_grads + 2 * grads_s + (8 * t["largest_shard"] if gb != 4 else 0)
    # the update: the clipped fp32 gradients (beside fp32 gradients, or in
    # place of the fp32 copies of bf16 ones), fp32 moments (new when stored
    # in bf16), den, u and the weight-decay product
    ph["optimizer"] = (persist + last_grads + grads_s + 4 * P_s
                       + (8 * P_s if mb != 4 else 0) + 3 * 4 * P_s)

    peak_at = max(ph, key=ph.get)
    total = ph[peak_at]
    mem = dict(master_fp32=master, adam_moments=moments,
               grad_carry=grads_l if (accum > 1 or pp) else grads_s,
               autograd_grads=autograd_grads, bf16_compute_copy=copy,
               activations=act, head_logits=a["head"] + a["head_bwd"],
               activation_parts=a, phases=ph, peak_at=peak_at, total=total,
               hbm=capacity, fits=bool(capacity is not None
                                       and total <= FIT_FRACTION * capacity),
               note="peak device memory a rank, from the port's code; headroom "
                    f"{1 - FIT_FRACTION:.2f} of the card for its context and "
                    "fragmentation")
    return mem, t


def _link(group_span, gpus_per_node):
    """The link a group whose ranks span `group_span` consecutive ranks
    crosses: 'nvlink' within a node, else 'infiniband'."""
    return "nvlink" if group_span <= gpus_per_node else "infiniband"


def collectives(cfg, sharding, n_dp, n_tp, n_sp, n_pp, t, *, mini, accum, ctx,
                grad_dtype, gpus_per_node):
    """{name: (bytes a rank sends a step, link)} of the port's collectives.
    The ranks of a 2-D mesh are laid out row-major (torch's DeviceMesh): a
    group on the second axis spans that many consecutive ranks, one on the
    first axis (and the world) the whole mesh."""
    cb = DTYPE_BYTES[cfg.compute_dtype]
    pp = sharding in ("pp", "fsdp+pp")
    gdt = 4 if pp else DTYPE_BYTES[grad_dtype]
    world = n_dp * n_tp * n_sp * n_pp
    second = n_tp * n_sp * n_pp
    T_l = ctx // n_sp
    N = mini * T_l
    D = cfg.n_embd
    remat = 1 if cfg.checkpoint_freq > 0 else 0
    ring = lambda n: 2 * (n - 1) / n
    half = lambda n: (n - 1) / n
    data_link = _link(world, gpus_per_node)
    inner_link = _link(second, gpus_per_node)
    out = {}
    split = t["split_local2"] + t["split_local1"]
    whole = t["local2"] + t["local1"] - split
    batch_n = n_dp * n_sp          # the group the gradients are summed over
    if batch_n > 1:
        if split:
            out["fsdp_param_allgather"] = (
                (cb * t["split_local2"] + 4 * t["split_local1"]) * half(n_dp), data_link)
            out["fsdp_grad_reducescatter"] = (gdt * split * half(n_dp), data_link)
        if whole:
            link = data_link if n_sp == 1 else _link(world, gpus_per_node)
            name = "sp_grad_allreduce" if n_sp > 1 else "dp_grad_allreduce"
            out[name] = (gdt * whole * ring(batch_n), link)
    if n_tp > 1:
        # a micro-batch, a layer: the two row-parallel outputs summed
        # forward (again in a remat recompute), the two column-parallel
        # inputs' gradients summed backward; the head's input gradient
        per = cb * N * D * ring(n_tp)
        out["tp_allreduce"] = (accum * cfg.n_layer * (4 + 2 * remat) * per, inner_link)
        Ns = head_slots(mini, T_l)
        out["tp_head"] = (accum * (cb * Ns * D + 3 * 4 * Ns) * ring(n_tp), inner_link)
    if n_sp > 1:
        # k and v one member on, n − 1 times a layer forward (and in a remat
        # recompute), their gradients back as many times; the ids gathered
        # once a forward
        kv = 2 * cb * N * D
        out["sp_ring_kv"] = (accum * cfg.n_layer * (2 + remat) * (n_sp - 1) * kv, inner_link)
        out["sp_ids_allgather"] = (accum * 4 * N * (n_sp - 1), inner_link)
    if pp:
        S, M = n_pp, accum
        act = cb * N * D
        if S > 1:
            # a middle stage sends every slot's output forward and its
            # input's cotangent back (a stage of one posts no P2P)
            out["pp_p2p"] = (M * act * (2 if S > 2 else 1), inner_link)
            out["pp_stage_grad_allreduce"] = (4 * t["shared"] * ring(S), inner_link)
            if M % S == 0:
                out["pp_head_broadcast"] = (2 * M * act, inner_link)
    if world > 1:
        out["clip_norm_allreduce"] = (4 * ring(world), _link(world, gpus_per_node))
    return out


def plan(cfg, *, chips, sharding, mesh, mini, accum, ctx,
         moment_dtype="float32", grad_dtype="float32", remat=0,
         remat_policy="full", fused_ce=False, hw="h100-sxm", util=MEASURED_UTIL,
         gpus_per_node=8, capacity=None, **overrides):
    """The plan as one dict (tools/pod_plan.py's keys). remat, remat_policy
    and fused_ce set cfg's checkpoint_freq, remat_policy and fused_ce;
    overrides replace figures of HW[hw] (peak, hbm, nvlink_gbs, ib_gbs); capacity: the card's memory in bytes (None: HW's)."""
    from omnibiote_tpu_torch.training.metrics import flops_per_token

    h = dict(HW[hw])
    h.update({k: v for k, v in overrides.items() if v is not None})
    cfg = cfg.replace(checkpoint_freq=remat, remat_policy=remat_policy, fused_ce=fused_ce)
    n_dp, n_tp, n_sp, n_pp = degrees(sharding, chips, mesh)
    if cfg.n_layer % n_pp or ctx % n_sp or cfg.n_head % n_tp:
        raise ValueError(f"the mesh ({n_dp}, {n_tp}, {n_sp}, {n_pp}) does not divide "
                         f"{cfg.n_layer} layers, ctx {ctx} and {cfg.n_head} heads")
    p = count_params(cfg)
    cap = h["hbm"] if capacity is None else capacity
    mem, held = memory(cfg, sharding, n_dp, n_tp, n_sp, n_pp, mini=mini, accum=accum,
                       ctx=ctx, moment_dtype=moment_dtype, grad_dtype=grad_dtype,
                       two_d=mesh is not None and len(mesh) == 2, capacity=cap)
    coll = collectives(cfg, sharding, n_dp, n_tp, n_sp, n_pp, held, mini=mini,
                       accum=accum, ctx=ctx, grad_dtype=grad_dtype,
                       gpus_per_node=gpus_per_node)

    # sp cuts the positions of the same rows, so it adds no tokens
    tokens_step = mini * n_dp * accum * ctx
    fpt = flops_per_token(p["non_embedding"], cfg.n_layer, cfg.n_embd, ctx)
    compute_s = tokens_step * fpt / (h["peak"] * chips * util)
    bubble = (n_pp - 1) / (accum + n_pp - 1) if n_pp > 1 else 0.0
    compute_s /= max(1.0 - bubble, 1e-9)
    times = {k: b / _link_rate(link, h) for k, (b, link) in coll.items()}
    comm_s = sum(times.values())
    step_s = max(compute_s, comm_s)
    return dict(
        model=dict(layers=cfg.n_layer, embd=cfg.n_embd, heads=cfg.n_head,
                   vocab=cfg.vocab_size, ctx=ctx, params=p["total"],
                   non_embedding=p["non_embedding"], dropout=cfg.dropout),
        parallel=dict(chips=chips, sharding=sharding, dp=n_dp, tp=n_tp, sp=n_sp, pp=n_pp,
                      mini=mini, accum=accum, remat=remat, remat_policy=remat_policy,
                      fused_ce=fused_ce, moment_dtype=moment_dtype,
                      grad_dtype=grad_dtype, gpus_per_node=gpus_per_node),
        memory_bytes=mem,
        flops=dict(per_token=fpt, tokens_per_step=tokens_step, bubble=bubble,
                   util_assumed=util, peak=h["peak"]),
        collectives_bytes={k: b for k, (b, _) in coll.items()},
        links={k: link for k, (_, link) in coll.items()},
        times_s=dict(compute=compute_s, collectives=comm_s, **times),
        projection=dict(step_s=step_s, tokens_per_sec=tokens_step / step_s,
                        bound="compute" if compute_s >= comm_s else "collectives",
                        estimate=True,
                        note="roofline estimate: no collective across cards has been "
                             "measured; overlap of collectives and compute is not "
                             "modelled"),
        hw=dict(name=hw, **h),
    )


def _link_rate(link, h):
    return (h["nvlink_gbs"] if link == "nvlink" else h["ib_gbs"]) * 1e9


def model_config(preset=None, layers=12, embd=1024, heads=12, vocab=2 ** 16, ctx=2048):
    """The port's model config of the flags (block_size max(ctx, 2048), as
    tools/pod_plan.py builds the JAX one)."""
    from omnibiote_tpu_torch.config import OmniBioTAConfig
    from omnibiote_tpu_torch.config import preset as named

    if preset:
        return named(preset, block_size=max(ctx, 2048))
    return OmniBioTAConfig(n_layer=layers, n_embd=embd, n_head=heads, vocab_size=vocab,
                           block_size=max(ctx, 2048))


def card_capacity():
    """The card's memory in bytes, or None without a CUDA device."""
    import torch
    if not torch.cuda.is_available():
        return None
    return torch.cuda.get_device_properties(0).total_memory


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default=None)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--embd", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=2 ** 16)
    ap.add_argument("--ctx", type=int, default=2048)
    ap.add_argument("--chips", type=int, default=8, help="GPUs in all")
    ap.add_argument("--sharding", default="fsdp", choices=list(MODES))
    ap.add_argument("--mesh", type=int, nargs="+", default=None,
                    help="the Trainer's mesh_shape: N, or (data, model|seq|stage)")
    ap.add_argument("--mini", type=int, default=8, help="micro-batch rows a data rank")
    ap.add_argument("--accum", type=int, default=16)
    ap.add_argument("--remat", type=int, default=0, help="checkpoint_freq")
    ap.add_argument("--remat-policy", default="full", choices=["full", "dots"])
    ap.add_argument("--fused-ce", action="store_true")
    ap.add_argument("--moment-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--grad-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--hw", default="h100-sxm", choices=sorted(HW))
    ap.add_argument("--util", type=float, default=MEASURED_UTIL,
                    help="compute utilization (default: the port's measured MFU on one "
                         "H100, PERF.md)")
    ap.add_argument("--gpus-per-node", type=int, default=8)
    ap.add_argument("--peak-flops", type=float, default=None)
    ap.add_argument("--hbm", type=float, default=None,
                    help="device memory in bytes (default: the card's, else HW's)")
    ap.add_argument("--nvlink-gbs", type=float, default=None)
    ap.add_argument("--ib-gbs", type=float, default=None)
    args = ap.parse_args(argv)

    cfg = model_config(args.preset, args.layers, args.embd, args.heads, args.vocab, args.ctx)
    cap = args.hbm if args.hbm is not None else card_capacity()
    out = plan(cfg, chips=args.chips, sharding=args.sharding, mesh=args.mesh,
               mini=args.mini, accum=args.accum, ctx=args.ctx,
               moment_dtype=args.moment_dtype, grad_dtype=args.grad_dtype,
               remat=args.remat, remat_policy=args.remat_policy, fused_ce=args.fused_ce,
               hw=args.hw, util=args.util, gpus_per_node=args.gpus_per_node,
               capacity=cap, peak=args.peak_flops,
               nvlink_gbs=args.nvlink_gbs, ib_gbs=args.ib_gbs)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
