#!/usr/bin/env python3
"""Where the time of an omnibiote-small encode batch goes on the GPU.

    python3 tools/gpu_profile_encode.py [--batch 32] [--ctx 1024] [--steps 4]
                                        [--quantize [--quantize_attention]]

Builds the PyTorch port's kernels, makes omnibiote-small at full width (8
layers, d 1024, 8 heads of 128, vocab 65536, bf16 compute) with random
weights from a seed, and runs `encode(model, tokens, "mean")` on random
tokens: the batch time by CUDA events, then a torch.profiler window over
`--steps` batches with the device time of every kernel, grouped as the
attention kernels (bf16 and int8 apart), matrix products, elementwise and
reductions, and the rest, and the device's idle share of the window.

With --quantize the same is done once more on the model quantized for int8
serving (`quantize_for_inference`; --quantize_attention also turns the int8
attention kernel on). There every matrix product of the window is the int8
one (`torch._int_mm`), and the quantise and rescale passes of `quant_linear`
are elementwise kernels like LayerNorm's: their group is the int8 run's
elementwise time less the bf16 run's, printed as such, beside the same
passes timed alone by CUDA events at the model's four shapes times the
layer count.

Where the profiler records no device time, it falls back to CUDA events:
the attention kernel alone at the same shape, times the layer count,
against the whole batch. Needs a CUDA device; prints the card's name and
power limit first.
"""
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ELEMENTWISE = "elementwise, reductions, gathers"
GROUPS = (
    ("attention (mh_flash_fwd: rope_rows, mh_fwd)", ("mh_fwd", "rope_rows")),
    ("int8 attention (int8_flash_fwd: quant_rows, v_absmax, quant_v, int8_fwd)",
     ("int8_fwd", "quant_rows", "v_absmax", "quant_v")),
    ("matrix products (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "cublas",
                                  "sm90_", "sm80_")),
    (ELEMENTWISE, ("elementwise", "vectorized", "reduce",
                   "index", "gather", "cat", "copy", "fill", "softmax", "norm")),
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


def profile_window(model, x, steps, top, label):
    """Profile `steps` encode batches; print the groups; return {group: ms a
    batch}, empty where the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from omnibiote_tpu_torch import encode

    batch_ms = cuda_ms(lambda: encode(model, x, "mean"), 8)
    print(f"[{label}] encode(mean) B={x.shape[0]} T={x.shape[1]}: {batch_ms:.3f} ms per "
          f"batch, {1e3 * x.shape[0] / batch_ms:.1f} seq/s (CUDA events)")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
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
    if total_us == 0:
        return {}, batch_ms
    busy_ms = total_us / 1e3 / steps
    print(f"[{label}] profiler window: {steps} batches, {window_ms / steps:.3f} "
          f"ms per batch on the host clock, device busy {busy_ms:.3f} ms "
          f"per batch, idle share {max(0.0, 1 - busy_ms * steps / window_ms):.3f}")
    groups = {}
    for name, us in by_name.items():
        groups[group_of(name)] = groups.get(group_of(name), 0.0) + us / 1e3 / steps
    for glabel, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"  {glabel:72s} {ms:8.3f} ms per batch ({100 * ms / busy_ms:5.1f} %)")
    print(f"[{label}] top {top} kernels by device time:")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"  {us / 1e3 / steps:8.3f} ms  {100 * us / total_us:5.1f} %  {name[:110]}")
    return groups, batch_ms


def quant_passes_ms(rows, cfg):
    """The quantise pass, the int8 product and the rescale pass of
    quant_linear, each timed alone by CUDA events at the model's four
    projection shapes: (quantise, product, rescale) ms a layer."""
    import torch
    from omnibiote_tpu_torch.ops import quant

    d = cfg.n_embd
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = [0.0, 0.0, 0.0]
    for K, N in ((d, 3 * d), (d, d), (d, 4 * d), (4 * d, d)):
        x = torch.randn(rows, K, generator=gen, device="cuda").to(cfg.cdtype())
        qw = quant.quantize_weight(torch.randn(N, K, generator=gen, device="cuda"))

        x_q, s_x = quant.quantize_rows(x)
        acc = quant._int8_matmul(x_q, qw.values)
        out[0] += cuda_ms(lambda: quant.quantize_rows(x), 10)
        out[1] += cuda_ms(lambda: quant._int8_matmul(x_q, qw.values), 10)
        out[2] += cuda_ms(lambda: quant.rescale(acc, s_x, qw.scale, None, x.dtype), 10)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--ctx", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--quantize", action="store_true",
                    help="also profile the model quantized for int8 serving")
    ap.add_argument("--quantize_attention", action="store_true",
                    help="with --quantize: int8 attention too")
    args = ap.parse_args(argv)
    if args.quantize_attention and not args.quantize:
        ap.error("--quantize_attention needs --quantize")

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("gpu_profile_encode: no CUDA device is available")
    sys.path.insert(0, ROOT)
    from omnibiote_tpu_torch import init_params, preset
    from omnibiote_tpu_torch.models.rope import rope_tables
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops.flash_attention import mh_flash_forward
    from omnibiote_tpu_torch.ops.quant import quantize_for_inference

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _kernels.build_all()
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(gen, cfg, device="cuda").eval()
    x = torch.randint(20, 65000, (args.batch, args.ctx), generator=gen,
                      device="cuda")
    groups, batch_ms = profile_window(model, x, args.steps, args.top, "bf16")
    if args.quantize:
        qmodel = quantize_for_inference(model)
        qmodel.cfg = qmodel.cfg.replace(attn_int8=args.quantize_attention)
        label = "int8 weights" + (" + int8 attention" if args.quantize_attention else "")
        qgroups, _ = profile_window(qmodel, x, args.steps, args.top, label)
        if groups and qgroups:
            print(f"[{label}] quantise and rescale passes of quant_linear (this run's "
                  f"elementwise group less the bf16 run's): "
                  f"{qgroups.get(ELEMENTWISE, 0.0) - groups.get(ELEMENTWISE, 0.0):.3f} ms per batch")
        qu, pr, re_ = quant_passes_ms(args.batch * args.ctx, cfg)
        print(f"[{label}] quant_linear's passes alone (CUDA events, the four shapes of a "
              f"layer x {cfg.n_layer} layers): quantise {qu * cfg.n_layer:.3f} ms, int8 "
              f"product {pr * cfg.n_layer:.3f} ms, rescale {re_ * cfg.n_layer:.3f} ms per batch")
    if groups:
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
