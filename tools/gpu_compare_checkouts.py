#!/usr/bin/env python3
"""Time the split backward pair, the per-head entry and the end-to-end rates
of two checkouts of this repo on one card, in turns.

    python3 tools/gpu_compare_checkouts.py --other DIR [--probes] [--json OUT]

DIR is another checkout (for example the parent commit's `git archive`,
unpacked into a git-ignored directory of this one). Each side runs in a
process of its own that imports that side's `omnibiote_tpu_torch` and
builds that side's kernels, in the order other, this, this, other, so that
a drift of the card over the call falls on both sides alike. A process
times, with `chip_smoke.py`'s own helpers and inputs:

  * the forward #1 and the fused backward #2 at the training shape, B=16
    T=1024, bench.py's rows (three EOS), RoPE, dropout 0.1, with segment
    skipping (CUDA events over 20 launches);
  * #1, the fused multi-kv backward #3 (`mh_flash_bwd_mk`) and the split
    pair #4 (`mh_flash_bwd_dkv`) and #5 (`mh_flash_bwd_dq`) at
    bench_longctx.py's shapes, B=8 T=2048 and B=4 T=4096, five EOS a row,
    RoPE, dropout 0.1, with segment skipping and without (CUDA events over
    10 launches; #1 and #3 with skipping only);
  * the per-head entry's #7 (`flash_bwd_dkv`) and #8 (`flash_bwd_dq`) at
    B=16 T=1024, bench.py's rows, dropout 0.1, no RoPE (20 launches);
  * `encode(mean)` seq/s at B=32 T=1024 (omnibiote-small, random weights);
  * train tokens/s of omnibiote-small at ctx 1024 (fused backward), ctx
    2048 (fused, and the split pair) and ctx 4096 (fused).

With --wide a process times only the backward kernels past head dim 256, at
2 heads of 512 and of 384 (omnibiote-small's width, `chip_smoke.py` phase
20's inputs): the fused #2 at B=16 T=1024 and #3 at B=8 T=2048, the split
pair #4 and #5 at B=8 T=2048, all with RoPE, dropout 0.1 and segment
skipping, the per-head #7 and #8 at B=16 T=1024 (no RoPE); and train
tokens/s of omnibiote-small at ctx 1024 with 2 heads of 512 and with its 8
heads of 128 (6 steps each), and at ctx 2048 (B=16, mini 8, 5 EOS a row)
with 2 heads of 512 on the fused backward and on the split pair and with 8
heads of 128 (6 steps each).

With --fp32 a process times only the fp32 instances of the attention
kernels at omnibiote-small's width in heads of 64, 128 and 256 (16, 8 and
4 heads), CUDA events over 10 launches, with segment skipping and without:
#1 (`mh_flash_fwd`) and #2 (`mh_flash_bwd`) at bench.py's B=16 T=1024
(three EOS a row), #3 (`mh_flash_bwd_mk`), #4 (`mh_flash_bwd_dkv`) and #5
(`mh_flash_bwd_dq`) at bench_longctx.py's B=8 T=2048 (five EOS a row), all
with RoPE and dropout 0.1, beside SDPA's forward and backward on the same
inputs (the efficient backend, the only one that takes fp32); and the
per-head entry's #6, #7 and #8 at B=16 T=1024 (no RoPE, every tile).

With --probes a process times only the dkv product-mix probe #11
(`probes.roofline.dots_n`, 3 and 4 products, 64- and 128-row CTAs) and #4's
kernel with its products alone (`dkv_products`) at the probes' shape (B=8,
T=1024, H=8, bq = bkv = 512, bf16 unit normals from seed 0), by CUDA graphs
of 20 calls and by CUDA events over 20 back-to-back calls.

It prints one JSON line a process and then, for every number, both sides'
mean and this side's ratio to the other's. Needs one CUDA device; prints the
card's name and power limit.

    python3 tools/gpu_compare_checkouts.py --measure ROOT [--probes | --wide | --fp32]

is one side's process (the package under ROOT; its JSON line last).
"""
import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure_probes(c):
    """#11 and dkv_products at the probes' shape: {name: ms}."""
    import numpy as np
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.probes import roofline as r1

    _kernels.build_all(["roofline_probes", "mh_flash_bwd_dkv"])
    B, T, H, D = (r1.PROBE_SHAPE[n] for n in "BTHD")
    q = r1.normal_bf16(np.random.default_rng(0), (B, T, H, D), "cuda")
    out = {}
    for nd in (3, 4):
        for cta in r1.CTA_ROWS:
            fn = lambda: r1.dots_n(q, q, q, 512, 512, nd, cta_q=cta)
            out[f"dots_n {nd} products cta={cta} graphs ms"] = c.graph_ms(fn)
            out[f"dots_n {nd} products cta={cta} events ms"] = c.cuda_ms(fn, 20)
    out["dkv_products graphs ms"] = c.graph_ms(lambda: r1.dkv_products(q, q, q, q))
    return out


def measure_fp32(c):
    """The fp32 attention kernels at head dims 64, 128 and 256 (see
    --fp32): {name: ms}."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    _kernels.build_all(["mh_flash_fwd", "mh_flash_bwd", "mh_flash_bwd_dkv", "mh_flash_bwd_dq"])
    out = {}
    for D in (64, 128, 256):
        H, scale = 1024 // D, 1.0 / math.sqrt(D)
        for B, T, n_eos in ((c.TRAIN_SHAPE["B"], 1024, 3), (c.LONG_SHAPES[0][0], 2048, c.LONG_EOS)):
            q, k, v, _, rope = c._attn_inputs(B, T, H, D, torch.float32, "dense", 2400 + T)
            seg = c._wide_ids("packed", B, T, n_eos, 2400 + T)
            gen = torch.Generator(device="cuda").manual_seed(2500 + T)
            do = torch.randn(B, T, H, D, generator=gen, device="cuda")
            kw = dict(scale=scale, dropout_rate=c.TRAIN_DROPOUT, seed=2563)
            sb = fa.SegmentBounds(seg)
            skip = dict(segment_skip=True, bounds=sb)
            tag = f"fp32 D={D} B={B} T={T}"

            def both(name, fn, n=10):
                out[f"{name} {tag} skip ms"] = c.cuda_ms(lambda: fn(**skip), n)
                out[f"{name} {tag} all tiles ms"] = c.cuda_ms(lambda: fn(), n)

            o, lse = fa.mh_flash_forward_plain(q, k, v, seg, rope, **kw)
            args = (q, k, v, do, lse, (o * do).sum(-1), seg, rope)
            del o
            if T == 1024:
                both("mh_flash_fwd", lambda **s: fa.mh_flash_forward(q, k, v, seg, rope, **kw, **s))
                both("mh_flash_bwd", lambda **s: fa.mh_flash_backward(*args, **kw, **s))
            else:
                both("mh_flash_bwd_mk", lambda **s: fa.mh_flash_backward(*args, **kw, **s))
                both("mh_flash_bwd_dkv", lambda **s: fa.mh_flash_bwd_dkv(*args, **kw, **s))
                both("mh_flash_bwd_dq", lambda **s: fa.mh_flash_bwd_dq(*args, **kw, **s))
            # one PyTorch call of the same function on the same inputs
            qr, kr = apply_rope_half(q, k, *rope)
            qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (qr, kr, v))
            doh = do.transpose(1, 2).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, dropout_p=c.TRAIN_DROPOUT,
                                                          scale=scale)
            try:
                with torch.no_grad():
                    fwd = c.cuda_ms(sdpa, 10)
                out[f"SDPA forward {tag} ms"] = fwd
                out[f"SDPA backward {tag} ms"] = c.cuda_ms(
                    lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), 5) - fwd
            except RuntimeError as err:
                print(f"SDPA at {tag}: {err}", file=sys.stderr)
            del q, k, v, do, lse, args, qr, kr, qh, kh, vh, doh
            torch.cuda.empty_cache()
        # the per-head entry (#6-#8): no RoPE, no bounds
        B, T = c.TRAIN_SHAPE["B"], 1024
        q, k, v, _, _ = c._attn_inputs(B, T, H, D, torch.float32, "dense", 2410)
        seg = c._wide_ids("packed", B, T, 3, 2410)
        do = torch.randn(B, T, H, D, generator=torch.Generator(device="cuda").manual_seed(2510),
                         device="cuda")
        kw = dict(scale=scale, dropout_rate=c.TRAIN_DROPOUT, seed=2564)
        o, lse = fa.mh_flash_forward_plain(q, k, v, seg, None, **kw)
        args = (q, k, v, do, lse, (o * do).sum(-1), seg, None)
        tag = f"fp32 D={D} B={B} T={T} per-head ms"
        out[f"flash_fwd {tag}"] = c.cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, None, **kw),
                                            10)
        out[f"flash_bwd_dkv {tag}"] = c.cuda_ms(lambda: fa.mh_flash_bwd_dkv(*args, **kw), 10)
        out[f"flash_bwd_dq {tag}"] = c.cuda_ms(lambda: fa.mh_flash_bwd_dq(*args, **kw), 10)
        del q, k, v, do, o, lse, args
        torch.cuda.empty_cache()
    return out


def measure_wide(c):
    """The backward kernels and the ctx-1024 train rate past head dim 256
    (see --wide): {name: value}."""
    import torch
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    _kernels.build_all(["mh_flash_fwd", "mh_flash_bwd", "mh_flash_bwd_dkv", "mh_flash_bwd_dq"])
    out, H = {}, c.WIDER_HEADS
    for D in (512, 384):
        scale = 1.0 / math.sqrt(D)
        for B, T, n_eos in ((c.TRAIN_SHAPE["B"], 1024, 3), (c.LONG_SHAPES[0][0], 2048, c.LONG_EOS)):
            q, k, v, _, rope = c._attn_inputs(B, T, H, D, torch.bfloat16, "dense", 2200 + T)
            seg = c._wide_ids("packed", B, T, n_eos, 2200 + T)
            gen = torch.Generator(device="cuda").manual_seed(2300 + T)
            do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
            sb = fa.SegmentBounds(seg)
            kw = dict(scale=scale, dropout_rate=c.TRAIN_DROPOUT, seed=2561)
            skip = dict(segment_skip=True, bounds=sb)
            o, lse = fa.mh_flash_forward(q, k, v, seg, rope, **kw, **skip)
            args = (q, k, v, do, lse, (o.float() * do.float()).sum(-1), seg, rope)
            name, n = ("mh_flash_bwd", 20) if T == 1024 else ("mh_flash_bwd_mk", 10)
            out[f"{name} D={D} B={B} T={T} skip ms"] = c.cuda_ms(
                lambda: fa.mh_flash_backward(*args, **kw, **skip), n)
            if T == 2048:
                for name, f in (("mh_flash_bwd_dkv", fa.mh_flash_bwd_dkv),
                                ("mh_flash_bwd_dq", fa.mh_flash_bwd_dq)):
                    out[f"{name} D={D} B={B} T={T} skip ms"] = c.cuda_ms(
                        lambda: f(*args, **kw, **skip), 10)
            if T == 1024:
                kwh = dict(scale=scale, dropout_rate=c.TRAIN_DROPOUT, seed=2562)
                oh, lseh = fa.mh_flash_forward(q, k, v, seg, None, **kwh)
                argsh = (q, k, v, do, lseh, (oh.float() * do.float()).sum(-1), seg, None)
                for name, f in (("flash_bwd_dkv", fa.mh_flash_bwd_dkv),
                                ("flash_bwd_dq", fa.mh_flash_bwd_dq)):
                    out[f"{name} D={D} B={B} T={T} per-head ms"] = c.cuda_ms(
                        lambda: f(*argsh, **kwh), 20)
                del oh, lseh, argsh
            del q, k, v, do, o, lse, args
            torch.cuda.empty_cache()
    tc = TrainConfig(batch_size=32, mini_batch_size=16, ctx_len=1024,
                     token_budget=float(32 * 1024 * 10000), seed=0)
    for n_head in (8, H):
        cfg = preset("omnibiote-small", vocab_size=65536, dropout=c.TRAIN_DROPOUT,
                     n_head=n_head, block_size=1024)
        label = f"ctx 1024, {n_head} heads of {cfg.n_embd // n_head}"
        out[f"train tokens/s {label}"] = c._throughput(cfg, tc, 3, 6, label)
    tc = TrainConfig(batch_size=16, mini_batch_size=8, ctx_len=2048,
                     token_budget=float(16 * 2048 * 10000), seed=0)
    for n_head, split in ((8, False), (H, False), (H, True)):
        cfg = preset("omnibiote-small", vocab_size=65536, dropout=c.TRAIN_DROPOUT,
                     n_head=n_head, block_size=2048)
        label = (f"ctx 2048, {n_head} heads of {cfg.n_embd // n_head}, "
                 f"{'split pair' if split else 'fused backward'}")
        with c._attention_switch(FUSED_MULTIKV_BWD=not split):
            out[f"train tokens/s {label}"] = c._throughput(cfg, tc, c.LONG_EOS, 6, label)
    return out


def measure(root, probes=False, wide=False, fp32=False):
    """One side's numbers: {name: value}."""
    root = os.path.abspath(root)
    sys.path.insert(0, HERE)
    import chip_smoke as c
    sys.path.insert(0, root)   # the side's package comes first
    import torch
    import omnibiote_tpu_torch
    from omnibiote_tpu_torch import init_params, preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    c.check(os.path.dirname(os.path.dirname(omnibiote_tpu_torch.__file__)) == root,
            f"imported {omnibiote_tpu_torch.__file__}, not the package under {root}")
    c.check(torch.cuda.is_available(), "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if probes:
        return measure_probes(c)
    if wide:
        return measure_wide(c)
    if fp32:
        return measure_fp32(c)
    _kernels.build_all(["mh_flash_fwd", "mh_flash_bwd", "mh_flash_bwd_dkv", "mh_flash_bwd_dq"])
    out = {}
    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)
    for B, T in c.LONG_SHAPES:
        q, k, v, _, rope = c._attn_inputs(B, T, H, D, torch.bfloat16, "dense", 600 + T)
        seg = c._long_segments("packed", B, T, 600 + T)
        gen = torch.Generator(device="cuda").manual_seed(700 + T)
        do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
        sb = fa.SegmentBounds(seg)
        kw = dict(scale=scale, dropout_rate=c.TRAIN_DROPOUT, seed=4242)
        o, lse = fa.mh_flash_forward(q, k, v, seg, rope, segment_skip=True, bounds=sb, **kw)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, do, lse, di, seg, rope)
        out[f"mh_flash_fwd B={B} T={T} skip ms"] = c.cuda_ms(
            lambda: fa.mh_flash_forward(q, k, v, seg, rope, segment_skip=True, bounds=sb,
                                        **kw), 10)
        out[f"mh_flash_bwd_mk B={B} T={T} skip ms"] = c.cuda_ms(
            lambda: fa.mh_flash_backward(*args, **kw, segment_skip=True, bounds=sb), 10)
        for name, f in (("mh_flash_bwd_dkv", fa.mh_flash_bwd_dkv),
                        ("mh_flash_bwd_dq", fa.mh_flash_bwd_dq)):
            out[f"{name} B={B} T={T} skip ms"] = c.cuda_ms(
                lambda: f(*args, **kw, segment_skip=True, bounds=sb), 10)
            out[f"{name} B={B} T={T} all tiles ms"] = c.cuda_ms(lambda: f(*args, **kw), 10)
        del q, k, v, do, o, lse, di, args
    B, T = c.TRAIN_SHAPE["B"], c.TRAIN_SHAPE["T"]
    q, k, v, _, rope = c._attn_inputs(B, T, H, D, torch.bfloat16, "dense", 976)
    seg = torch.from_numpy(next(c.bench_batches(B, T, seed=976))["segments"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(979)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
    sb = fa.SegmentBounds(seg)
    kw = dict(scale=scale, dropout_rate=c.TRAIN_DROPOUT, seed=4243)
    o, lse = fa.mh_flash_forward(q, k, v, seg, rope, segment_skip=True, bounds=sb, **kw)
    args = (q, k, v, do, lse, (o.float() * do.float()).sum(-1), seg, rope)
    out[f"mh_flash_fwd B={B} T={T} skip ms"] = c.cuda_ms(
        lambda: fa.mh_flash_forward(q, k, v, seg, rope, segment_skip=True, bounds=sb, **kw), 20)
    out[f"mh_flash_bwd B={B} T={T} skip ms"] = c.cuda_ms(
        lambda: fa.mh_flash_backward(*args, **kw, segment_skip=True, bounds=sb), 20)
    del q, k, v, do, o, lse, args
    q, k, v, _, _ = c._attn_inputs(B, T, H, D, torch.bfloat16, "dense", 977)
    seg = torch.from_numpy(next(c.bench_batches(B, T, seed=977))["segments"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(978)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
    kw = dict(scale=scale, dropout_rate=c.TRAIN_DROPOUT, seed=31337)
    o, lse = fa.mh_flash_forward(q, k, v, seg, None, **kw)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, di, seg, None)
    out["flash_bwd_dkv per-head ms"] = c.cuda_ms(lambda: fa.mh_flash_bwd_dkv(*args, **kw), 20)
    out["flash_bwd_dq per-head ms"] = c.cuda_ms(lambda: fa.mh_flash_bwd_dq(*args, **kw), 20)
    del q, k, v, do, o, lse, di, args
    torch.cuda.empty_cache()

    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.0)
    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    x = torch.randint(20, 65000, (c.SERVING_BATCH, cfg.block_size),
                      generator=torch.Generator(device="cuda").manual_seed(1), device="cuda")
    out["encode(mean) seq/s"] = c._encode_rate(model, x, "bf16")
    del model, x
    for mini, ctx, n_eos, steps, split in ((16, 1024, 3, 10, False), (8, 2048, 5, 8, False),
                                           (8, 2048, 5, 8, True), (4, 4096, 5, 6, False)):
        cfg = preset("omnibiote-small", vocab_size=65536, dropout=c.TRAIN_DROPOUT,
                     block_size=ctx)
        tc = TrainConfig(batch_size=2 * mini, mini_batch_size=mini, ctx_len=ctx,
                         token_budget=float(2 * mini * ctx * 10000), seed=0)
        label = f"ctx {ctx}, {'split pair' if split else 'fused backward'}"
        switch = ("FUSED_SINGLE_KV_BWD" if ctx <= 1024 else "FUSED_MULTIKV_BWD")
        old = getattr(fa, switch)
        setattr(fa, switch, not split)
        try:
            out[f"train tokens/s {label}"] = c._throughput(cfg, tc, n_eos, steps, label)
        finally:
            setattr(fa, switch, old)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="the other checkout's root")
    ap.add_argument("--measure", help="measure the package under this root (one side)")
    ap.add_argument("--probes", action="store_true",
                    help="time only the dkv product-mix probe and dkv_products")
    ap.add_argument("--wide", action="store_true",
                    help="time only the backward kernels and the train rate past head dim 256")
    ap.add_argument("--fp32", action="store_true",
                    help="time only the fp32 attention kernels at head dims 64, 128 and 256")
    ap.add_argument("--json", help="write both sides' runs here")
    a = ap.parse_args(argv)
    if a.measure:
        print(json.dumps({"root": os.path.abspath(a.measure),
                          **measure(a.measure, a.probes, a.wide, a.fp32)}))
        return
    if not a.other:
        ap.error("--other DIR is needed")
    sides = {"other": os.path.abspath(a.other), "this": HERE}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    runs = []
    for side in ("other", "this", "this", "other"):
        flags = [f for f, on in (("--probes", a.probes), ("--wide", a.wide),
                                 ("--fp32", a.fp32)) if on]
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--measure",
                               sides[side], *flags],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"{side} ({sides[side]}) failed:\n{proc.stdout[-4000:]}"
                             f"\n{proc.stderr[-4000:]}")
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append({"side": side, **line})
        print(json.dumps(runs[-1]), flush=True)
    keys = [k for k in runs[0] if k not in ("side", "root")]
    print(f"{'number':52s} {'other':>12s} {'this':>12s} {'this/other':>10s}")
    for k in keys:
        mean = {s: sum(r[k] for r in runs if r["side"] == s) / 2 for s in ("other", "this")}
        print(f"{k:52s} {mean['other']:12.4f} {mean['this']:12.4f} "
              f"{mean['this'] / mean['other']:10.4f}")
    if a.json:
        with open(a.json, "w") as f:
            json.dump(runs, f, indent=1)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())


if __name__ == "__main__":
    main()
