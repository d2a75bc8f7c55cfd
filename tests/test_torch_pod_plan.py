"""tools/gpu_pod_plan.py, the port's pod planner, on the CPU.

Its parameter counts equal the JAX planner's (tools/pod_plan.py) and the
port's `num_params`; its masters, moments and compute copy equal the JAX
plan's where the two packages hold the same tensors, and follow the port's
placements where they do not (hand-worked below); the activation bytes a
block keeps are counted on a real training forward of a small model; the
collectives equal the JAX plan's where the algorithm is the same; the links,
the bubble, the projection and the fits verdict.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)

import io
import json
import os
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import gpu_pod_plan as gp  # noqa: E402
import pod_plan as jax_plan  # noqa: E402

from omnibiote_tpu_torch.config import OmniBioTAConfig  # noqa: E402
from omnibiote_tpu_torch.models.omnibiota import OmniBioTA, init_params, num_params  # noqa: E402
from omnibiote_tpu_torch.training.mlm import mlm_loss  # noqa: E402
from omnibiote_tpu_torch.training.train import _compute_copy  # noqa: E402

SMALL = dict(preset="omnibiote-small")
BIG = dict(layers=16, embd=2048, heads=16)          # ROADMAP item 11's third row
TINY = dict(layers=2, embd=256, heads=2, vocab=512)


def _cfgs(spec, ctx=1024):
    """(port config, JAX config) of one model spec."""
    from omnibiote_tpu.config import OmniBioTAConfig as JaxConfig
    from omnibiote_tpu.config import preset as jax_preset

    port = gp.model_config(ctx=ctx, **spec)
    if "preset" in spec:
        return port, jax_preset(spec["preset"], block_size=max(ctx, 2048))
    return port, JaxConfig(n_layer=spec["layers"], n_embd=spec["embd"],
                           n_head=spec["heads"], vocab_size=spec.get("vocab", 2 ** 16),
                           block_size=max(ctx, 2048))


@pytest.mark.parametrize("spec", [SMALL, BIG, TINY], ids=["small", "16L-2048d", "tiny"])
def test_count_params_equals_jax_and_num_params(spec):
    cfg, jcfg = _cfgs(spec)
    ours = gp.count_params(cfg)
    assert ours == jax_plan.count_params(jcfg)
    model = OmniBioTA(cfg, device="meta")
    assert ours["total"] == num_params(model, non_embedding=False)
    assert ours["non_embedding"] == num_params(model, non_embedding=True)
    if spec is SMALL:
        assert ours["total"] == 234_898_432
    if spec is BIG:
        assert ours["total"] == 1_073_809_408


# (mode, GPUs, the Trainer's mesh_shape) of the comparisons with the JAX plan
MODES = [("replicated", 8, None), ("fsdp", 8, None), ("tp", 8, None),
         ("fsdp+tp", 8, (2, 4)), ("pp", 4, (4,)), ("fsdp+pp", 8, (2, 4)), ("sp", 4, None)]


def _both(mode, chips, mesh, spec=SMALL, **kw):
    cfg, jcfg = _cfgs(spec)
    args = {**dict(mini=4, accum=4, ctx=1024), **kw}
    ours = gp.plan(cfg, chips=chips, sharding=mode, mesh=mesh, **args)
    theirs = jax_plan.plan(jcfg, chips=chips, sharding=mode,
                           mesh=tuple(mesh) if mesh and len(mesh) == 2 else None,
                           **args)
    return cfg, ours, theirs


@pytest.mark.parametrize("mode,chips,mesh", MODES, ids=[m[0] for m in MODES])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_master_moments_and_compute_copy(mode, chips, mesh, moments):
    """Where both packages hold the same tensors (dp, fsdp, pp, fsdp+pp,
    sp) the masters and moments are the JAX plan's. Under tp the port also
    splits the head's vocabulary and keeps every LayerNorm whole (the JAX
    planner's approximation splits the blocks' share of the parameters):
    the port's numbers are worked by hand. The compute copy casts only the
    ≥2-D weights (a 1-D tensor's copy is its fp32 master), where the JAX
    planner counts every parameter at 2 bytes; fsdp gathers its split 1-D
    tensors in fp32."""
    cfg, ours, theirs = _both(mode, chips, mesh, moment_dtype=moments)
    m, j = ours["memory_bytes"], theirs["memory_bytes"]
    p = gp.count_params(cfg)
    P, V, D, L = p["total"], cfg.vocab_size, cfg.n_embd, cfg.n_layer
    ln = 2 * D * L + D                     # the 1-D tensors: two LayerNorms a block, ln_f
    mb = 4 if moments == "float32" else 2
    if mode in ("tp", "fsdp+tp"):
        n_dp, n_tp = (1, chips) if mesh is None else mesh
        split = (p["blocks"] - 2 * D * L) + V * D      # Megatron blocks and the vocab
        local = P - split + split // n_tp
        assert m["master_fp32"] == 4 * local // n_dp
        assert m["adam_moments"] == 2 * mb * local // n_dp
        assert m["bf16_compute_copy"] == 2 * (local - ln) + (4 * ln if n_dp > 1 else 0)
        assert m["master_fp32"] < j["master_fp32"]     # the head is split too
        return
    assert m["master_fp32"] == j["master_fp32"]
    assert m["adam_moments"] == j["adam_moments"]
    n_pp = mesh[-1] if mode in ("pp", "fsdp+pp") else 1
    ln_local = 2 * D * L // n_pp + D
    if mode in ("fsdp", "fsdp+pp"):
        assert m["bf16_compute_copy"] == j["bf16_compute_copy"] + 2 * ln_local
    else:
        assert m["bf16_compute_copy"] == j["bf16_compute_copy"] - 2 * ln_local


def test_gradients_and_step_phases_by_hand():
    """The port's gradients, worked by hand on one GPU (the JAX planner
    counts one grad carry): the plain step keeps the autograd gradients of
    the compute copy (bf16 weights, fp32 LayerNorms), accumulates them in
    grad_dtype (fp32 copies first), and its last micro-batch's gradients are
    still bound during the update, whose foreach ops add the clipped
    gradients, den, u and the weight-decay product (and fp32 copies of bf16
    moments); the pp step sums bf16 `.grad` in autograd and copies it to
    fp32."""
    cfg = gp.model_config(ctx=1024, **SMALL)
    P = gp.count_params(cfg)["total"]
    P1 = 2 * cfg.n_embd * cfg.n_layer + cfg.n_embd
    P2 = P - P1
    plain = gp.plan(cfg, chips=1, sharding="replicated", mesh=None, mini=16, accum=2,
                    ctx=1024)["memory_bytes"]
    g = 2 * P2 + 4 * P1
    assert plain["autograd_grads"] == g
    assert plain["grad_carry"] == 4 * P
    ph = plain["phases"]
    assert ph["accumulate"] == 12 * P + 2 * P2 + 4 * P + g + 4 * P2
    assert ph["optimizer"] == 12 * P + g + 4 * P + 4 * P + 12 * P
    bf = gp.plan(cfg, chips=1, sharding="replicated", mesh=None, mini=16, accum=2, ctx=1024,
                 moment_dtype="bfloat16", grad_dtype="bfloat16")["memory_bytes"]
    assert bf["grad_carry"] == 2 * P
    assert bf["phases"]["optimizer"] == 8 * P + g + 2 * P + 4 * P + 8 * P + 12 * P
    pp = gp.plan(cfg, chips=1, sharding="pp", mesh=(1,), mini=16, accum=2,
                 ctx=1024)["memory_bytes"]
    assert pp["grad_carry"] == 4 * P
    assert pp["phases"]["grad_copy"] == 12 * P + 2 * P2 + g + 4 * P2
    assert pp["phases"]["optimizer"] == 12 * P + 4 * P + 4 * P + 12 * P
    assert "reduce" not in pp["phases"]      # a ('stage',) mesh of one: nothing to sum


def test_pp_slots_by_hand():
    """GPipe keeps every active slot's activations, its input and output
    until its backward, and the slots' heads until the readout's backward;
    under remat a stage's slice is one checkpoint (its input)."""
    cfg = gp.model_config(ctx=1024, **SMALL)
    kw = dict(chips=1, sharding="pp", mesh=(1,), mini=16, ctx=1024)
    a = gp.activation_bytes(cfg, 16, 1024)
    xb = 2 * cfg.n_embd * a["tokens"]
    for accum in (1, 2, 4):
        act = gp.plan(cfg, accum=accum, **kw)["memory_bytes"]["activations"]
        held = accum * (cfg.n_layer * a["layer"] + 2 * xb + a["embed"])
        assert act == held + accum * (a["ln_f"] + a["head"]) + a["head_bwd"]
    r = cfg.replace(checkpoint_freq=1)
    act = gp.plan(cfg, accum=2, remat=1, **kw)["memory_bytes"]["activations"]
    a = gp.activation_bytes(r, 16, 1024)
    held = 2 * (2 * xb + a["embed"])
    assert act == max(held + 2 * (a["ln_f"] + a["head"]) + a["head_bwd"],
                      held + a["block_bwd"] + 2 * cfg.vocab_size * cfg.n_embd
                      + cfg.n_layer * a["layer"])


# ---------------------------------------------------------------------------
# The activation term, counted on a training forward
# ---------------------------------------------------------------------------

B, T = 2, 256


def _tiny(L, cf=0, policy="full", fused=False):
    return OmniBioTAConfig(n_layer=L, n_embd=256, n_head=2, vocab_size=512, block_size=T,
                           dropout=0.1, checkpoint_freq=cf, remat_policy=policy,
                           fused_ce=fused)


def _forward_inputs(cfg):
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = _compute_copy(dict(model.named_parameters()), cfg)
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(4, 500, (B, T)).astype(np.int32))
    seg = torch.from_numpy(np.repeat(np.arange(4), T // 4)[None].repeat(B, 0)
                           .astype(np.int32))
    return model, params, tok, seg


def _kept_bytes(cfg):
    """Bytes the CPU allocator still holds when a training forward (mask,
    model, head, loss) returns: its allocations less its frees, from the
    profiler's memory record."""
    from torch.profiler import ProfilerActivity, profile

    model, params, tok, seg = _forward_inputs(cfg)
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        loss, _ = mlm_loss(model, tok, seg, 7, params=params)
    return sum(e.self_cpu_memory_usage for e in prof.events())


def test_layer_bytes_equal_what_saved_tensor_hooks_see():
    """Remat off: the tensors each block's forward hands autograd to save,
    deduplicated by storage (parameters, their compute copy and the model's
    buffers excluded), are the planner's bytes a layer."""
    from omnibiote_tpu_torch.models import omnibiota

    cfg = _tiny(2)
    model, params, tok, seg = _forward_inputs(cfg)
    skip = {t.untyped_storage().data_ptr() for t in
            [*params.values(), *model.parameters(), *model.buffers()]}
    seen, where = {}, [None]
    block_forward = omnibiota.Block.forward

    def tagged(self, *a, **kw):
        outer, where[0] = where[0], id(self)
        try:
            return block_forward(self, *a, **kw)
        finally:
            where[0] = outer

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in skip:
            seen.setdefault(s.data_ptr(), (where[0], s.nbytes()))
        return t

    omnibiota.Block.forward = tagged
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            mlm_loss(model, tok, seg, 7, params=params)
    finally:
        omnibiota.Block.forward = block_forward
    per_layer = {}
    for layer, nbytes in seen.values():
        per_layer[layer] = per_layer.get(layer, 0) + nbytes
    want = gp.activation_bytes(cfg, B, T)
    blocks = [v for k, v in per_layer.items() if k is not None]
    assert len(blocks) == 2
    for got in blocks:
        assert abs(got / want["layer"] - 1) < 0.02, (got, want["layer"])
    outside = want["embed"] + want["ln_f"] + want["head"]
    assert abs(per_layer[None] / outside - 1) < 0.02, (per_layer[None], outside)


@pytest.mark.parametrize("cf,policy", [(0, "full"), (1, "full"), (1, "dots")],
                         ids=["off", "full", "dots"])
@pytest.mark.parametrize("fused", [False, True], ids=["plain_head", "fused_ce"])
def test_layer_bytes_kept_under_each_remat_policy(cf, policy, fused):
    """What a layer adds to the bytes a forward leaves allocated (2 layers
    against 1) is the planner's `layer_kept`: every saved tensor without
    remat, the block's input under 'full' (torch.utils.checkpoint keeps its
    inputs and nothing it saves), its input and four product outputs under
    'dots'; and the rest of the forward (embedding, ln_f, head) its
    `embed + ln_f + head`."""
    two, one = _kept_bytes(_tiny(2, cf, policy, fused)), _kept_bytes(_tiny(1, cf, policy, fused))
    want = gp.activation_bytes(_tiny(2, cf, policy, fused), B, T)
    assert abs((two - one) / want["layer_kept"] - 1) < 0.02, (two - one, want["layer_kept"])
    rest = one - want["layer_kept"]
    assert abs(rest / (want["embed"] + want["ln_f"] + want["head"]) - 1) < 0.02


# ---------------------------------------------------------------------------
# Collectives, links, bubble, projection, fits
# ---------------------------------------------------------------------------

def test_collectives_equal_jax_where_the_algorithm_is():
    """DDP's gradient all-reduce and fsdp's reduce-scatter are the JAX
    plan's; fsdp's all-gather adds the 1-D tensors' fp32 bytes; tp's
    all-reduces a micro-batch are the JAX plan's (the JAX planner counts one
    micro-batch, the port A of them, and the head's input gradient); the
    ring's k/v rotation is the JAX plan's under remat (its recompute
    rotates again) and 2/3 of it without."""
    _, ours, theirs = _both("replicated", 8, None)
    assert ours["collectives_bytes"]["dp_grad_allreduce"] == \
        theirs["collectives_bytes"]["dp_grad_allreduce"]
    cfg, ours, theirs = _both("fsdp", 8, None)
    c, j = ours["collectives_bytes"], theirs["collectives_bytes"]
    assert c["fsdp_grad_reducescatter"] == j["fsdp_grad_reducescatter"]
    ln = 2 * cfg.n_embd * cfg.n_layer + cfg.n_embd
    assert c["fsdp_param_allgather"] == pytest.approx(j["fsdp_param_allgather"]
                                                      + 2 * ln * 7 / 8)
    for accum in (1, 4):
        _, ours, theirs = _both("tp", 8, None, **{"accum": 1} if accum == 1 else {})
        assert ours["collectives_bytes"]["tp_allreduce"] == pytest.approx(
            accum * theirs["collectives_bytes"]["tp_allreduce"])
    _, ours, theirs = _both("sp", 4, None, remat=1)
    assert ours["collectives_bytes"]["sp_ring_kv"] == theirs["collectives_bytes"]["sp_ring_kv"]
    _, ours, theirs = _both("sp", 4, None)
    assert 3 * ours["collectives_bytes"]["sp_ring_kv"] == \
        2 * theirs["collectives_bytes"]["sp_ring_kv"]
    # pp: a middle stage sends each slot's output and its input's cotangent
    # (the JAX planner counts every tick, bubble ones too)
    cfg, ours, _ = _both("pp", 4, (4,))
    act = 2 * 4 * 1024 * cfg.n_embd
    assert ours["collectives_bytes"]["pp_p2p"] == 4 * act * 2
    # a one-stage mesh posts no P2P (pipeline.py::_exchange has no
    # neighbour), broadcasts nothing and reduces nothing over 'stage'
    one = gp.plan(cfg, chips=1, sharding="pp", mesh=(1,), mini=4, accum=4, ctx=1024)
    assert one["collectives_bytes"] == {} and one["times_s"]["collectives"] == 0


def test_links_within_and_across_nodes():
    cfg = gp.model_config(ctx=1024, **SMALL)
    kw = dict(mini=4, accum=2, ctx=1024)
    links = gp.plan(cfg, chips=8, sharding="fsdp", mesh=None, **kw)["links"]
    assert set(links.values()) == {"nvlink"}
    links = gp.plan(cfg, chips=16, sharding="fsdp", mesh=None, **kw)["links"]
    assert links["fsdp_param_allgather"] == "infiniband"
    plan = gp.plan(cfg, chips=16, sharding="fsdp+tp", mesh=(2, 8), **kw)
    assert plan["links"]["tp_allreduce"] == "nvlink"
    assert plan["links"]["fsdp_param_allgather"] == "infiniband"
    assert plan["times_s"]["tp_allreduce"] == pytest.approx(
        plan["collectives_bytes"]["tp_allreduce"] / 450e9)
    assert plan["times_s"]["fsdp_param_allgather"] == pytest.approx(
        plan["collectives_bytes"]["fsdp_param_allgather"] / 50e9)
    four = gp.plan(cfg, chips=16, sharding="fsdp+tp", mesh=(2, 8), gpus_per_node=4, **kw)
    assert four["links"]["tp_allreduce"] == "infiniband"
    fast = gp.plan(cfg, chips=16, sharding="fsdp+tp", mesh=(2, 8), ib_gbs=100.0, **kw)
    assert fast["times_s"]["fsdp_param_allgather"] == pytest.approx(
        plan["times_s"]["fsdp_param_allgather"] / 2)


def test_bubble_projection_and_fits():
    cfg = gp.model_config(ctx=1024, **SMALL)
    plan = gp.plan(cfg, chips=4, sharding="pp", mesh=(4,), mini=4, accum=8, ctx=1024)
    assert plan["flops"]["bubble"] == pytest.approx(3 / 11)
    proj = plan["projection"]
    assert proj["step_s"] > 0 and proj["tokens_per_sec"] > 0 and proj["estimate"]
    assert "estimate" in proj["note"]
    assert plan["flops"]["util_assumed"] == gp.MEASURED_UTIL == 0.1814
    one = gp.plan(cfg, chips=1, sharding="replicated", mesh=None, mini=16, accum=2, ctx=1024)
    assert one["flops"]["bubble"] == 0.0
    assert one["memory_bytes"]["hbm"] == 80e9 and one["memory_bytes"]["fits"]
    assert not gp.plan(cfg, chips=1, sharding="replicated", mesh=None, mini=16, accum=2,
                       ctx=1024, capacity=16 * 2 ** 30)["memory_bytes"]["fits"]
    huge = gp.model_config(layers=48, embd=8192, heads=64, ctx=1024)
    assert not gp.plan(huge, chips=1, sharding="replicated", mesh=None, mini=8, accum=2,
                       ctx=1024)["memory_bytes"]["fits"]
    assert set(gp.HW) == {"h100-sxm"}


def test_cli_prints_one_json_object_with_the_jax_keys():
    out = io.StringIO()
    with redirect_stdout(out):
        gp.main(["--preset", "omnibiote-small", "--chips", "8", "--sharding", "fsdp",
                 "--ctx", "2048", "--mini", "8", "--accum", "16", "--remat", "1",
                 "--remat-policy", "dots", "--fused-ce", "--hbm", "80e9"])
    plan = json.loads(out.getvalue())
    for key in ("model", "parallel", "memory_bytes", "flops", "collectives_bytes",
                "times_s", "projection"):
        assert key in plan
    assert plan["parallel"]["remat_policy"] == "dots" and plan["parallel"]["fused_ce"]
    assert plan["memory_bytes"]["total"] == max(plan["memory_bytes"]["phases"].values())
