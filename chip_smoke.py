#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (omnibiote_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one H100 (sm_90a), the CUDA
toolkit and g++. It

  1. builds the port's CUDA kernels (nvcc, one process per source, all at
     once) and its tokenizer (g++) from the checkout's sources;
  2. kernel phase: holds each kernel against its plain PyTorch version on
     the card, at the main path's shapes, in bf16 and fp32, over packed,
     padded and dense segment layouts, and times the kernel, the plain
     version and one PyTorch library call that computes the same function;
  3. slice phase: builds the `Encoder` at omnibiote-small full width (8
     layers, d 1024, 8 heads of 128, vocab 65536, bf16 compute, random
     weights from a seed, a BPE vocabulary trained on synthetic sequences),
     encodes 64 sequences of mixed lengths with every pooling, masked and
     leaky, checks that every layer's attention went through the kernel,
     holds the embeddings against the same model with the plain attention,
     and times `encode(..., "mean")` at B=32, T=1024;
  4. prints the card's name and power limit, one JSON line of kernel
     numbers, and last the line {"ok": true, "device": {...}}.

Any failed check raises, and the script then exits non-zero without the
last line. Without a CUDA device, or without the package beside it, it
fails at once.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
# bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs its plain version (same tile order, same rounding points):
# fp32 differs only in the order of fp32 sums; in bf16 such a difference can
# flip the rounding of P or of o by one bf16 ulp (2^-8 relative), so o is
# held to 4 ulps at |o| ~ 1. lse2 is fp32 in both.
TOL = {"bfloat16": dict(o=(8e-3, 8e-3), lse=(1e-5, 1e-4)),
       "float32": dict(o=(2e-5, 2e-5), lse=(1e-5, 1e-4))}
# Embeddings of the kernel path vs the plain attention, per row.
MIN_COSINE = 0.999


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out


def cuda_ms(fn, iters, warmup=2):
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# 1. build
# ---------------------------------------------------------------------------

def build():
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch import tokenizer

    t0 = time.time()
    with ThreadPoolExecutor(2) as pool:
        kernels = pool.submit(_kernels.build_all, None, True)
        spm = pool.submit(tokenizer._load_lib)
        logs = kernels.result()
        spm.result()
    print(f"build: {time.time() - t0:.1f} s (nvcc sm_90a: "
          f"{', '.join(logs) or 'up to date'}; g++ tokenizer)")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 2. kernel phase
# ---------------------------------------------------------------------------

def _segments(layout, B, T, gen):
    import torch
    if layout == "dense":
        return None
    if layout == "packed":
        # EOS-delimited documents: consecutive ids, ~1 boundary per 96 tokens
        cuts = torch.rand(B, T, generator=gen, device="cuda") < 1 / 96
        return torch.cumsum(cuts.int(), 1).int().contiguous()
    # padded tail: real tokens 0, from a per-row length on -1
    n = torch.randint(T // 8, T, (B, 1), generator=gen, device="cuda")
    pos = torch.arange(T, device="cuda")[None]
    return torch.where(pos < n, 0, -1).int().contiguous()


def _attn_inputs(B, T, H, D, dtype, layout, seed):
    import torch
    from omnibiote_tpu_torch.models.rope import rope_tables
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, T, H, D, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    return q, k, v, _segments(layout, B, T, gen), rope_tables(D, T, device="cuda")


def _attn_bound(B, T, H, D):
    """(bound_ms, bound_by) of one bf16 call with RoPE and no mask: the
    larger of its operations over the bf16 peak and its bytes (q, k, v and
    the rope tables read once, o and lse2 written once) over HBM bandwidth."""
    flops = 4.0 * B * T * T * H * D
    nbytes = 4 * B * T * H * D * 2 + B * T * H * 4 + 2 * T * (D // 2) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_phase():
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops.flash_attention import (
        KERNEL_KV_TILE, mh_flash_forward, mh_flash_forward_plain)

    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)
    worst = {}
    cases = [(4, 1024, dt, lay) for dt in ("bfloat16", "float32")
             for lay in ("packed", "padded", "dense")]
    cases += [(32, 384, "bfloat16", "padded"), (32, 1024, "bfloat16", "dense")]
    for i, (B, T, dtype, layout) in enumerate(cases):
        tdt = getattr(torch, dtype)
        q, k, v, seg, rope = _attn_inputs(B, T, H, D, tdt, layout, seed=i)
        o, lse = mh_flash_forward(q, k, v, seg, rope, scale=scale)
        torch.cuda.synchronize()
        po, plse = mh_flash_forward_plain(q, k, v, seg, rope, scale=scale,
                                          block_kv=KERNEL_KV_TILE[tdt])
        check(torch.isfinite(o.float()).all() and torch.isfinite(lse).all(),
              f"non-finite kernel output at {(B, T, dtype, layout)}")
        err_o = (o.float() - po.float()).abs().max().item()
        err_l = (lse - plse).abs().max().item()
        rt, at = TOL[dtype]["o"]
        ok_o = torch.allclose(o.float(), po.float(), rtol=rt, atol=at)
        rl, al = TOL[dtype]["lse"]
        ok_l = torch.allclose(lse, plse, rtol=rl, atol=al)
        print(f"kernel vs plain B={B} T={T} {dtype:8s} {layout:6s}: "
              f"max|do| {err_o:.3e} (rtol {rt}, atol {at}) "
              f"max|dlse2| {err_l:.3e} (rtol {rl}, atol {al})")
        check(ok_o and ok_l, f"kernel disagrees with its plain version at "
              f"{(B, T, dtype, layout)}")
        worst[dtype] = max(worst.get(dtype, 0.0), err_o)
        del q, k, v, o, lse, po, plse

    # timing at the main path's shape: encode at B=32, T=1024, bf16, no mask
    B, T = 32, 1024
    q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 99)
    ms = cuda_ms(lambda: mh_flash_forward(q, k, v, None, rope, scale=scale), 20)
    plain_ms = cuda_ms(lambda: mh_flash_forward_plain(
        q, k, v, None, rope, scale=scale), 5, warmup=1)
    qr, kr = apply_rope_half(q, k, *rope)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (qr, kr, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 20)
    bound_ms, bound_by = _attn_bound(B, T, H, D)
    # the padded layout the masked encode gives, beside its SDPA with the
    # boolean mask
    _, _, _, pseg, _ = _attn_inputs(B, T, H, D, torch.bfloat16, "padded", 98)
    ms_pad = cuda_ms(lambda: mh_flash_forward(q, k, v, pseg, rope, scale=scale), 20)
    mask = (pseg[:, :, None] == pseg[:, None, :])[:, None]
    library_pad = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale), 20)
    tflops = 4.0 * B * T * T * H * D / (ms * 1e-3) / 1e12
    print(f"mh_flash_fwd B={B} T={T} H={H} D={D} bf16 dense: kernel {ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); padded: "
          f"kernel {ms_pad:.4f} ms, SDPA with mask {library_pad:.4f} ms")
    return {"name": "mh_flash_fwd", "route": "cuda",
            "source": "omnibiote_tpu_torch/ops/csrc/mh_flash_fwd.cu",
            "replaces": "omnibiote_tpu/ops/flash_attention.py:545",
            "launches": None, "max_abs_err": worst["bfloat16"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


# ---------------------------------------------------------------------------
# 3. slice phase
# ---------------------------------------------------------------------------

def _sequences(rng, n, min_len, max_len):
    """Tagged synthetic DNA / protein strings, log-uniform lengths."""
    out = []
    for i in range(n):
        length = int(math.exp(rng.uniform(math.log(min_len), math.log(max_len))))
        if i % 2:
            out.append("<protein>" + "".join(rng.choice("ACDEFGHIKLMNPQRSTVWY")
                                             for _ in range(length)))
        else:
            out.append("<DNA>" + "".join(rng.choice("ACGT") for _ in range(length)))
    return out


def slice_phase(workdir):
    import random
    import torch
    from omnibiote_tpu_torch import init_params, encode, preset
    from omnibiote_tpu_torch.api import Encoder
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import attention as port_attention
    from omnibiote_tpu_torch.ops.flash_attention import mh_flash_forward_plain
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor, train_bpe

    rng = random.Random(0)
    tok_path = os.path.join(workdir, "synthetic.model")
    corpus = [s + "<EOS>" for s in _sequences(rng, 400, 40, 400)]
    train_bpe(corpus, vocab_size=512, out_path=tok_path,
              user_defined=["<EOS>", "<DNA>", "<protein>"])
    sp = SentencePieceProcessor(tok_path)

    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.0)
    check((cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.block_size,
           cfg.compute_dtype, cfg.param_dtype, cfg.attn_impl)
          == (8, 1024, 8, 1024, "bfloat16", "float32", "flash"),
          f"unexpected omnibiote-small config {cfg}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(gen, cfg, device="cuda")
    enc = Encoder(model, sp, device="cuda")
    seqs = _sequences(rng, 64, 10, 6000)
    n_tok = [len(t) for t in sp.encode_batch(seqs)]
    print(f"slice: omnibiote-small {cfg.n_layer}L/{cfg.n_embd}d/{cfg.n_head}h "
          f"vocab {cfg.vocab_size}, {len(seqs)} sequences of "
          f"{min(n_tok)}..{max(n_tok)} tokens (+EOS, cut at {cfg.block_size})")

    batch_size = 32
    n_batches = -(-len(seqs) // batch_size)
    runs = [(m, masked) for m in ("mean", "first", "last", "max")
            for masked in (True, False)]
    outs = {}
    # main path: every count at 0 just before, read just after
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    for method, masked in runs:
        before = _kernels.LAUNCHES["mh_flash_fwd"]
        out = enc.encode_sequences(seqs, method=method, batch_size=batch_size,
                                   mask_padding=masked)
        check(out.shape == (len(seqs), cfg.n_embd) and out.dtype.name == "float32",
              f"{method}/{masked}: shape {out.shape} dtype {out.dtype}")
        check(bool(torch.isfinite(torch.from_numpy(out)).all()),
              f"{method}/{masked}: non-finite embeddings")
        got = _kernels.LAUNCHES["mh_flash_fwd"] - before
        check(got == cfg.n_layer * n_batches,
              f"{method}/{masked}: {got} kernel launches, want "
              f"{cfg.n_layer} layers x {n_batches} batches")
        outs[(method, masked)] = out
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    want = cfg.n_layer * n_batches * len(runs)
    check(launches["mh_flash_fwd"] == want,
          f"main path launched mh_flash_fwd {launches['mh_flash_fwd']} times, want {want}")
    print(f"slice: {len(runs)} encode_sequences calls in {wall:.2f} s, "
          f"launches {launches}")

    # the same model with the plain attention on the card
    kernel_fn = port_attention.mh_flash_forward
    port_attention.mh_flash_forward = mh_flash_forward_plain
    try:
        worst = 1.0
        for method, masked in runs:
            ref = enc.encode_sequences(seqs, method=method,
                                       batch_size=batch_size, mask_padding=masked)
            a, b = torch.from_numpy(outs[(method, masked)]), torch.from_numpy(ref)
            cos = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=1)
            worst = min(worst, cos.min().item())
            check(cos.min().item() >= MIN_COSINE,
                  f"{method}/{masked}: min row cosine {cos.min().item():.6f} "
                  f"vs the plain attention < {MIN_COSINE}")
    finally:
        port_attention.mh_flash_forward = kernel_fn
    check(_kernels.LAUNCHES == launches, "the plain run launched the kernel")
    print(f"slice: kernel path vs plain attention, min row cosine {worst:.7f} "
          f"(threshold {MIN_COSINE})")

    # encode throughput at ctx 1024, as bench.py times it
    x = torch.randint(20, 65000, (batch_size, cfg.block_size),
                      generator=gen, device="cuda")
    for _ in range(2):
        encode(model, x, "mean")
    torch.cuda.synchronize()
    steps = 16
    t0 = time.time()
    for _ in range(steps):
        e = encode(model, x, "mean")
    torch.cuda.synchronize()
    dt = time.time() - t0
    check(bool(torch.isfinite(e.float()).all()), "non-finite encode output")
    sps = steps * batch_size / dt
    print(f"encode(mean) B={batch_size} T={cfg.block_size} bf16: {sps:.1f} seq/s "
          f"({1e3 * dt / steps:.3f} ms per batch)")
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if not os.path.isdir(os.path.join(ROOT, "omnibiote_tpu_torch")):
        raise SystemExit("chip_smoke: omnibiote_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(gpu_name_and_power())
    build()
    row = kernel_phase()
    with tempfile.TemporaryDirectory() as workdir:
        launches = slice_phase(workdir)
    row["launches"] = launches[row["name"]]
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path was never launched: {launches}")
    print(json.dumps({"kernels": [row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
