"""Pretraining CLI, flag-compatible with the JAX package's
(`omnibiote_tpu/training/cli.py`, itself the reference's
train_encoder.py:437-467 flags):

    python -m omnibiote_tpu_torch.training.cli --base_dir /data \\
        --train_type mixed --n_layer 8 --n_embd 1024 --n_head 8 \\
        --ctx_len 1024 --dropout 0.1 --mini_batch_size 16 --batch_size 32

Trains on one GPU (--device cpu for the CPU), with every flag of the JAX
CLI: --checkpoint_freq > 0 with --remat_policy full or dots rematerialises
every block. Under torchrun, one process a GPU, the world is the mesh:

    torchrun --nproc_per_node 8 -m omnibiote_tpu_torch.training.cli \
        --sharding fsdp --multihost ...

--sharding replicated (DDP, the default), fsdp (--FSDP), tp and fsdp+tp,
--mesh_shape over ('data', 'model'); --sharding sp (ring attention) with
--mesh_shape N (the whole mesh the sequence axis) or D S (('data', 'seq'),
dp x sp), e.g. at ctx 4096 over 4 GPUs:

    torchrun --nproc_per_node 4 -m omnibiote_tpu_torch.training.cli \
        --sharding sp --mesh_shape 4 --ctx_len 4096 ...

and on one GPU a ring of one; --sharding pp (the GPipe schedule,
parallel/pipeline.py) with --mesh_shape S (every rank a stage, S dividing
--n_layer) or D S (('data', 'stage'), dp x pp), and --sharding fsdp+pp
with --mesh_shape D S (a 1-D mesh raises, as in the JAX CLI), e.g. 8 layers
as 4 stages of 2 over 2 data groups:

    torchrun --nproc_per_node 8 -m omnibiote_tpu_torch.training.cli \
        --sharding pp --mesh_shape 2 4 --multihost ...

--multihost gives each data group a pipeline of its own (data_hosts = the
mesh's data-axis size, host_id = the rank's data index, as
jax.process_count() / process_index() are in the JAX CLI, whose processes
each hold a whole model group): the ranks of one data group (its model,
seq or stage ranks) build the same pipeline; without it every rank builds
the same global stream and takes its rows. sp with more than one data host
raises, as in the JAX Trainer. Only rank 0 logs.
"""
from __future__ import annotations

import argparse
import os

import torch.distributed as dist

from ..config import OmniBioTAConfig, TrainConfig
from ..data.loader import build_pipeline
from .checkpoint import latest_checkpoint
from .metrics import JsonlSink, MultiSink, WandbSink
from .train import Trainer, choose_mesh


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="OmniBioTA MLM pretraining (GPU)")
    # reference flags (train_encoder.py:438-466), same names and defaults
    p.add_argument("--batch_size", type=int, default=1024,
                   help="The total batch size")
    p.add_argument("--mini_batch_size", type=int, default=8,
                   help="Micro batch for gradient accumulation")
    p.add_argument("--n_head", type=int, default=8)
    p.add_argument("--n_embd", type=int, default=1024)
    p.add_argument("--n_layer", type=int, default=8)
    p.add_argument("--ctx_len", type=int, default=2048)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--beta2", type=float, default=0.999)
    p.add_argument("--epsilon", type=float, default=1e-8)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--token_budget", type=float, default=20e9)
    p.add_argument("--test_freq", type=float, default=1e7)
    p.add_argument("--save_freq", type=float, default=1e9)
    p.add_argument("--save_name", type=str, default="omnibiota")
    p.add_argument("--disable_flash", action="store_true", default=False)
    p.add_argument("--wandb_project_name", type=str, default="omnibiota")
    p.add_argument("--base_dir", type=str, default="")
    p.add_argument("--force_lr", action="store_true", default=False)
    p.add_argument("--checkpoint_freq", type=int, default=0)
    p.add_argument("--banned_token", type=int, default=None)
    p.add_argument("--warmup_period", type=float, default=0.05)
    p.add_argument("--batch_ramp", action="store_true", default=False)
    p.add_argument("--train_type", type=str, default="mixed")
    p.add_argument("--use_padding", action="store_true", default=False)
    p.add_argument("--FSDP", action="store_true", default=False)
    p.add_argument("--resume_from", type=int, default=0,
                   help="Token count to resume from (0 = fresh; -1 = latest)")
    # the JAX package's additions
    p.add_argument("--save_dir", type=str, default="checkpoints")
    p.add_argument("--async_checkpoint", action="store_true",
                   help="write checkpoints from a background thread")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--metrics_jsonl", type=str, default=None)
    p.add_argument("--wandb", action="store_true", default=False)
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of 3 steps, then exit")
    p.add_argument("--log_every", type=int, default=10,
                   help="steps between metric fetches (each waits for the GPU)")
    p.add_argument("--multihost", action="store_true", default=False)
    p.add_argument("--sharding", type=str, default=None,
                   choices=["replicated", "fsdp", "tp", "sp", "pp",
                            "fsdp+tp", "fsdp+pp"])
    p.add_argument("--mesh_shape", type=int, nargs="+", default=None,
                   metavar="N")
    p.add_argument("--moment_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--grad_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--remat_policy", type=str, default="full",
                   choices=["full", "dots"])
    p.add_argument("--gelu", type=str, default="auto",
                   choices=["auto", "fast", "erf"])
    # the port's own
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the GPU)")
    return p


def main(argv=None) -> int:
    """The `obt-torch-train` console script: trains, saves the final
    checkpoint, and returns the exit code (0)."""
    run(argv)
    return 0


def run(argv=None):
    """Parse `argv` as the CLI does, train, and return the Trainer (closed)."""
    args = build_argparser().parse_args(argv)
    rank, world = 0, 1
    if args.multihost or "WORLD_SIZE" in os.environ:
        from ..parallel.mesh import init_distributed
        init_distributed(args.device)
        rank, world = dist.get_rank(), dist.get_world_size()
        print(f"rank {rank} of {world}")
    sharding = args.sharding or ("fsdp" if args.FSDP else "replicated")
    attn_impl = "xla" if args.disable_flash else "flash"
    if sharding == "sp":
        attn_impl = "ring"
    model_cfg = OmniBioTAConfig(
        block_size=args.ctx_len, vocab_size=2 ** 16, n_layer=args.n_layer,
        n_head=args.n_head, n_embd=args.n_embd, dropout=args.dropout,
        checkpoint_freq=args.checkpoint_freq,
        remat_policy=args.remat_policy, gelu=args.gelu, attn_impl=attn_impl)
    train_cfg = TrainConfig(
        batch_size=args.batch_size, mini_batch_size=args.mini_batch_size,
        ctx_len=args.ctx_len, lr=args.lr, beta1=args.beta1, beta2=args.beta2,
        epsilon=args.epsilon, weight_decay=args.weight_decay,
        token_budget=args.token_budget, test_freq=args.test_freq,
        save_freq=args.save_freq, save_name=args.save_name,
        async_checkpoint=args.async_checkpoint,
        save_dir=args.save_dir, force_lr=args.force_lr,
        banned_token=args.banned_token, warmup_period=args.warmup_period,
        batch_ramp=args.batch_ramp, train_type=args.train_type,
        use_padding=args.use_padding, resume_from=args.resume_from,
        base_dir=args.base_dir, seed=args.seed, log_every=args.log_every,
        sharding=sharding,
        mesh_shape=tuple(args.mesh_shape) if args.mesh_shape else None,
        moment_dtype=args.moment_dtype, grad_dtype=args.grad_dtype)

    # one pipeline a data group (its stripe of the shard files), as one a
    # host in the JAX CLI
    mesh, data_hosts, host_id = None, 1, 0
    if args.multihost:
        from ..parallel.mesh import DATA_AXIS, axis_index, axis_size
        mesh = choose_mesh(train_cfg, args.device)
        data_hosts, host_id = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)

    train_dirs, val_dirs, val_names, proportions = train_cfg.mixture
    banned = [args.banned_token] if args.banned_token is not None else []
    batch_iter, reader_states = build_pipeline(
        args.base_dir, train_dirs, proportions,
        batch_size=args.batch_size, ctx_len=args.ctx_len,
        use_padding=args.use_padding, banned_tokens=banned, seed=args.seed,
        num_hosts=data_hosts, host_id=host_id)
    val_iters = {}
    for name, vdir in zip(val_names, val_dirs):
        vit, _ = build_pipeline(
            args.base_dir, [vdir], [1.0], batch_size=args.mini_batch_size,
            ctx_len=args.ctx_len, use_padding=args.use_padding,
            banned_tokens=banned, seed=args.seed + 7919)
        val_iters[name] = vit

    # the metrics are global (summed over the ranks in the step): rank 0
    # alone logs them
    sink = MultiSink(
        JsonlSink(args.metrics_jsonl if rank == 0 else None,
                  echo=rank == 0 and args.metrics_jsonl is None),
        WandbSink(args.wandb_project_name, enabled=args.wandb and rank == 0))
    trainer = Trainer(model_cfg, train_cfg, batch_iter=batch_iter,
                      reader_states=reader_states, metrics_sink=sink,
                      prefetch=2, data_hosts=data_hosts, device=args.device,
                      mesh=mesh)
    try:
        if args.resume_from:
            if args.resume_from < 0:
                path = latest_checkpoint(args.save_dir, args.save_name)
            else:
                path = os.path.join(args.save_dir,
                                    f"{args.save_name}_{args.resume_from}")
            if path is None or not os.path.isdir(path):
                raise FileNotFoundError(f"no checkpoint at {path}")
            trainer.restore_checkpoint(path)
            print(f"Resumed from {path} (tokens={trainer.trained_tokens})")
        if args.profile_dir:
            out = trainer.profile(trace_dir=args.profile_dir)
            print(f"profile written to {out}")
            return trainer
        trainer.run(max_steps=args.max_steps, val_iters=val_iters)
        trainer.save_checkpoint(final=True)
        return trainer
    finally:
        trainer.close()
        sink.close()


if __name__ == "__main__":
    raise SystemExit(main())
