#!/usr/bin/env python3
"""Where the time of an omnibiote-small encode batch goes on the GPU.

    python3 tools/gpu_profile_encode.py [--batch 32] [--ctx 1024] [--steps 4]

Builds the PyTorch port's kernels, makes omnibiote-small at full width (8
layers, d 1024, 8 heads of 128, vocab 65536, bf16 compute) with random
weights from a seed, and runs `encode(model, tokens, "mean")` on random
tokens: the batch time by CUDA events, then a torch.profiler window over
`--steps` batches with the device time of every kernel, grouped as the
attention kernel, matrix products, elementwise and reductions, and the
rest, and the device's idle share of the window. Where the profiler records
no device time, it falls back to CUDA events: the attention kernel alone at
the same shape, times the layer count, against the whole batch. Needs a
CUDA device; prints the card's name and power limit first.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = (
    ("attention (mh_flash_fwd: rope_k, mh_fwd)", ("mh_fwd", "rope_k")),
    ("matrix products (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "cublas",
                                  "sm90_", "sm80_")),
    ("elementwise, reductions, gathers", ("elementwise", "vectorized", "reduce",
                                          "index", "gather", "cat", "copy",
                                          "fill", "softmax", "norm")),
)


def group_of(name):
    low = name.lower()
    for label, keys in GROUPS:
        if any(k in low for k in keys):
            return label
    return "other"


def cuda_ms(fn, iters, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gpu_profile_encode: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from torch.profiler import ProfilerActivity, profile
    from omnibiote_tpu_torch import encode, init_params, preset
    from omnibiote_tpu_torch.models.rope import rope_tables
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops.flash_attention import mh_flash_forward

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _kernels.build_all()
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(gen, cfg, device="cuda")
    x = torch.randint(20, 65000, (args.batch, args.ctx), generator=gen,
                      device="cuda")
    batch_ms = cuda_ms(lambda: encode(model, x, "mean"), 8)
    print(f"encode(mean) B={args.batch} T={args.ctx}: {batch_ms:.3f} ms per "
          f"batch, {1e3 * args.batch / batch_ms:.1f} seq/s (CUDA events)")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            encode(model, x, "mean")
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    by_name, total_us = {}, 0.0
    for evt in prof.events():
        if "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        us = evt.time_range.elapsed_us()
        by_name[evt.name] = by_name.get(evt.name, 0.0) + us
        total_us += us
    if total_us > 0:
        busy_ms = total_us / 1e3 / args.steps
        print(f"profiler window: {args.steps} batches, {window_ms / args.steps:.3f} "
              f"ms per batch on the host clock, device busy {busy_ms:.3f} ms "
              f"per batch, idle share {max(0.0, 1 - busy_ms * args.steps / window_ms):.3f}")
        groups = {}
        for name, us in by_name.items():
            groups[group_of(name)] = groups.get(group_of(name), 0.0) + us
        for label, us in sorted(groups.items(), key=lambda kv: -kv[1]):
            print(f"  {label:34s} {us / 1e3 / args.steps:8.3f} ms per batch "
                  f"({100 * us / total_us:5.1f} %)")
        print(f"top {args.top} kernels by device time:")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:args.top]:
            print(f"  {us / 1e3 / args.steps:8.3f} ms  {100 * us / total_us:5.1f} %  "
                  f"{name[:110]}")
        return 0

    print("the profiler recorded no device time; CUDA events instead:")
    H, D = cfg.n_head, cfg.head_dim
    q = torch.randn(args.batch, args.ctx, H, D, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    rope = rope_tables(D, args.ctx, device="cuda")
    attn_ms = cuda_ms(lambda: mh_flash_forward(q, q, q, None, rope,
                                               scale=cfg.attn_scale), 8)
    print(f"  attention kernel {attn_ms:.3f} ms x {cfg.n_layer} layers = "
          f"{attn_ms * cfg.n_layer:.3f} ms of {batch_ms:.3f} ms "
          f"({100 * attn_ms * cfg.n_layer / batch_ms:.1f} %)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
