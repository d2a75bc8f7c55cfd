#!/usr/bin/env python3
"""Where the time of an omnibiote-small MLM train step goes on the GPU.

    python3 tools/gpu_profile_train.py [--mini 16] [--accum 2] [--ctx 1024] [--eos 3]
                                       [--split] [--no_skip] [--fp32] [--steps 3]

Builds the PyTorch port's kernels, makes the port's `Trainer` for
omnibiote-small at full width (8 layers, d 1024, 8 heads of 128, vocab
65536, dropout 0.1, bf16 compute, fp32 parameters and moments) with random
weights from a seed, and feeds it `bench.py`'s batches (random tokens with
`--eos` EOS a row, segment ids from them) through its prefetch thread
(`--mini 8 --ctx 2048 --eos 5` and `--mini 4 --ctx 4096 --eos 5` are
`bench_longctx.py`'s shapes; `--split` takes the split dkv / dq backward
pair instead of the fused kernel; `--no_skip` makes every attention call
walk every tile, masked ones included; `--fp32` computes in fp32, as a
checkpoint whose `compute_dtype` is float32 does, so that the fp32
instances of the attention kernels run). After
three warm-up steps it times steps on the host clock around a
synchronised window, then records a torch.profiler window over `--steps`
steps: the device time of every kernel, grouped as elementwise and
reductions, cuBLAS matrix products, attention forward, attention backward,
RoPE pre-rotation, optimizer, and the rest, and the device's idle share of
the window (the host gaps). Needs a CUDA device; prints the card's name
and power limit first.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (
    ("attention forward (mh_fwd)", ("mh_fwd",)),
    ("attention backward (mh_bwd, dq_epilogue)", ("mh_bwd", "dq_epilogue")),
    ("attention RoPE pre-rotation (rope_rows)", ("rope_rows",)),
    ("optimizer (foreach / multi-tensor)", ("multi_tensor", "foreach")),
    ("matrix products (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "cublas",
                                  "sm90_", "sm80_")),
    ("elementwise, reductions, gathers", ("elementwise", "vectorized", "reduce",
                                          "index", "gather", "scatter", "cat",
                                          "copy", "fill", "softmax", "norm",
                                          "random", "distribution", "sort",
                                          "memset", "memcpy")),
)


def group_of(name):
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mini", type=int, default=16)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--eos", type=int, default=3, help="EOS tokens a row")
    ap.add_argument("--split", action="store_true",
                    help="the split dkv / dq backward instead of the fused one")
    ap.add_argument("--no_skip", action="store_true",
                    help="walk every attention tile (no segment skipping)")
    ap.add_argument("--fp32", action="store_true", help="fp32 compute (the parity type)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gpu_profile_train: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as port_flash
    from omnibiote_tpu_torch.training.train import Trainer
    from chip_smoke import bench_batches

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _kernels.build_all()
    if args.split:
        port_flash.FUSED_SINGLE_KV_BWD = port_flash.FUSED_MULTIKV_BWD = False
    if args.no_skip:
        port_flash._skip_and_bounds = lambda *a: (False, None)
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.1,
                 block_size=args.ctx, compute_dtype="float32" if args.fp32 else "bfloat16")
    batch = args.mini * args.accum
    tc = TrainConfig(batch_size=batch, mini_batch_size=args.mini,
                     ctx_len=args.ctx, token_budget=float(batch * args.ctx * 10000),
                     seed=0)
    with Trainer(cfg, tc, batch_iter=bench_batches(batch, args.ctx, 0, args.eos),
                 prefetch=2) as tr:
        for _ in range(3):
            tr.train_step_once()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            m = tr.train_step_once()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
        print(f"train step B={batch} (mini {args.mini} x accum {args.accum}) "
              f"T={args.ctx}, {args.eos} EOS a row, "
              f"{'split' if args.split else 'fused'} backward, "
              f"{'every tile' if args.no_skip else 'skipping'}, {cfg.compute_dtype}: "
              f"{step_ms:.3f} ms, "
              f"{batch * args.ctx / step_ms * 1e3:.1f} "
              f"tokens/s (host clock, synchronised), loss {float(m['loss']):.4f}")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                tr.train_step_once()
            torch.cuda.synchronize()
            window_ms = 1e3 * (time.perf_counter() - t0)
    by_name, total_us = {}, 0.0
    for evt in prof.events():
        if "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        total_us += us
    if total_us == 0:
        print("the profiler recorded no device time")
        return 1
    busy_ms = total_us / 1e3 / args.steps
    print(f"profiler window: {args.steps} steps, {window_ms / args.steps:.3f} ms per "
          f"step on the host clock, device busy {busy_ms:.3f} ms per step, idle "
          f"share (host gaps) {max(0.0, 1 - busy_ms * args.steps / window_ms):.3f}")
    groups = {}
    for name, us in by_name.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + us
    for label, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {label:44s} {us / 1e3 / args.steps:9.3f} ms per step "
              f"({100 * us / total_us:5.1f} %)")
    print(f"top {args.top} kernels by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
        print(f"  {us / 1e3 / args.steps:9.3f} ms  {100 * us / total_us:5.1f} %  "
              f"{name[:110]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
