#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (omnibiote_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one H100 (sm_90a), the CUDA
toolkit and g++. It

  1. builds the port's CUDA kernels (nvcc, one process per source, all at
     once) and its tokenizer (g++) from the checkout's sources, printing
     each kernel's registers, spills and stack frame (none may spill in
     the backward's wgmma kernels, in a bf16 kernel past D = 256, in the
     wgmma forwards there or in any fp32 instance of #1-#5 up to D = 256,
     and ptxas may serialise the products of neither those forwards nor
     the probes), and the shared memory of the bf16
     forward's and backward kernels' CTAs and of the int8 kernel's;
  2. kernel phase: holds each kernel against its plain PyTorch version on
     the card, at the main paths' shapes, in bf16 and fp32, over packed,
     padded and dense segment layouts: the forward without dropout (the
     serving path) and with dropout 0.1 (and at head dim 64, packed, with
     and without dropout), the fused backward and the split pair at
     dropout 0 and 0.1 (and once at T=2048, and at head dim 64); refuses a bf16 fused
     backward at T=192 at the wrapper; times each kernel, its plain version
     and one PyTorch library call that computes the same function, and
     holds kernel against plain once more at the very shape it timed,
     where the fused backward's walked tiles meet its bounds' count;
  3. serving slice: builds the `Encoder` at omnibiote-small full width (8
     layers, d 1024, 8 heads of 128, vocab 65536, bf16 compute, random
     weights from a seed, a BPE vocabulary trained on synthetic sequences),
     encodes 64 sequences of mixed lengths with every pooling, masked and
     leaky, checks that every layer's attention went through the kernel,
     holds the embeddings against the same model with the plain attention,
     and times `encode(..., "mean")` at B=32, T=1024;
  4. training slice, omnibiote-small at full width with dropout 0.1:
     one micro-batch of `mlm_loss` and its backward, and one train step
     with two accumulation slots, each run on the kernels and again on the
     plain versions with the same weights, batch and seeds (loss, every
     gradient's cosine, grad_norm); then the training CLI for 4 steps over
     synthetic token shards (launch counts, finite loss, the final
     checkpoint reloaded) and one more step resumed from that checkpoint;
     then train-step throughput at bench.py's shape;
  5. long-context kernels, at T=2048 (and once at 4096), bf16 and fp32,
     packed / padded / dense rows, dropout 0 and 0.1: the forward with
     segment-skip bounds, the fused multi-kv backward with bounds, and the
     split pair (dkv and dq kernels), each against its plain version;
     skipping on against off (forward, dkv and dq bit for bit, the fused
     backward's dq within its atomic sums' tolerance); the split pair
     twice (dk, dv and dq the same bits); fused against split; the tiles
     each kernel walked against the count its bounds give; the
     lse-exposing variant with a random lse cotangent; and the timings at
     bench_longctx.py's shapes (mini 8 x 2048 and mini 4 x 4096, five EOS
     a row; the split pair also without dropout);
  6. long-context training slice, omnibiote-small at full width with
     block_size = ctx_len = 2048: one micro-batch and one train step
     (A = 2) on the kernels with the fused backward, again with the split
     pair, and on the plain versions; the training CLI at --ctx_len 2048
     with a checkpoint and a resumed step; launch counts a step for every
     kernel; throughput with skipping and the fused backward, with every
     tile walked, with the split pair, and at ctx 4096; peak allocated
     memory;
  7. int8 kernel: the int8 attention kernel's prologue (q8, k8, v8 and
     their scales) against the plain version's integers in the kernel's
     layout (`int8_kernel_layout`), the kernel against
     `int8_flash_attention_plain` and the attention kernel alone against
     the call at B=2, T in {128, 640, 1024, 2048}, packed / padded / dense
     rows, bf16 and fp32, RoPE and none, and its products alone
     (`probes.roofline.int8_products`) against their plain version bit for
     bit; once more at the serving shape B=32, T=1024, dense and padded,
     where it is also held against the bf16 forward kernel (row cosine)
     and timed whole, as its prologue, its attention kernel and its
     products alone, beside its plain version, its bound and SDPA in bf16;
  8. int8 products: `quant_linear` on the card at M = 32,768 rows and the
     model's four (K, N): the int32 result bit for bit against a float64
     product of the same integers, and its time split into product and
     quantise / rescale passes beside the bf16 `F.linear`;
  9. int8 serving slice at full width and depth: `Encoder(quantize=True,
     quantize_attention=True)` on the serving slice's 64 sequences, every
     pooling, masked and leaky (8 int8 launches a batch, none of the bf16
     kernel), against the same quantized model with the plain int8
     attention and against the bf16 Encoder; `Encoder(quantize=True)` (the
     bf16 kernel, 8 a batch); the FASTA CLI with --quantize from a
     checkpoint; `encode(mean)` seq/s and peak memory of the three;
 10. per-head entry: `flash_attention(multi_head=False)` forward and
     backward against the plain versions at B=2, T=1024, dropout 0 and
     0.1, packed and dense, bf16 and fp32; at B=16, T=1024 each of its
     three kernels timed beside its plain version, its bound and (the
     forward) SDPA, and its launch counts;
 11. roofline probes (`omnibiote_tpu_torch.probes`): the four probe
     kernels (#1's two products alone and k pre-transposed or not, the dkv
     product mix, all on wgmma and TMA; the score product summed over heads
     as a wgmma GEMM) and #1's own kernel with its products alone
     (`fwd_products`) against their plain versions at H=2, T 256, 512 and
     1024, at ragged T (B=2, T 192 and 320, cta_q 64, the last 128-row kv
     tile or 256-column score tile past its bounds; the dkv mix at T=384
     with kv tiles of 96 and 192 rows and 64-row q chunks) and at the
     probes' shape B=8, T=1024, H=8, with 64- and 128-row CTAs, #10/#11/#12
     persistent and one CTA a work item; each timed (CUDA graphs, and CUDA events over
     back-to-back calls, as the probe tables time them) beside its plain version, its
     bound and a PyTorch library call, #13 against both layouts of k, #10
     persistent against one CTA an item and against `fwd_products`; #2's
     kernel and the split pair's with their products alone
     (`bwd_products`, `dkv_products`, `dq_products`) against their plain
     versions likewise; then both probe tables, whose launches are the
     rows' counts, and #1's and #2's splits into products and the rest;
 12. eval slice (the fine-tuning harness, `omnibiote_tpu_torch.evals`):
     #1 and #2 against their plain versions at B=4, T 128, 256, 512 and
     1024 with PAD-tail rows as `pad_batch` lays them out, and at the
     contact eval's B=1, T=1024 row with a PAD tail, bf16 and fp32,
     dropout 0 and 0.1; then omnibiote-small at full width (dropout 0.1,
     random weights from a seed, written as a checkpoint, the serving
     slice's vocabulary) through `run_gue` (one domain-MLM step, then the
     classifier at B 4 x accum 8), `run_proteinglue` on SS3 frozen and with
     `train_backbone=True`, `run_tape` on fluorescence, `run_pronab` and
     `run_pdb_contact`, over synthetic fixtures whose token lengths span
     those buckets: finite metrics, forward launches in every family,
     backward launches exactly where the backbone trains, none of another
     attention kernel; `finetune_classifier` on the kernels against the
     plain attention (dropout 0, 2 steps: losses, the first micro-batch's
     gradients, the val logits); each family's wall time and peak memory,
     the fine-tune rate at the GUE shape, the idle share of one fine-tune
     step, the frozen-embedding rate and the domain-MLM peak memory at
     B=32, T=1024;
 13. pretraining from raw records and the memory levers, omnibiote-small at
     full width with dropout 0.1: a seeded synthetic GenBank release
     (LOCUS / ORIGIN records of several molecule types) and UniRef100
     FASTA through `preprocessing.genbank.main`, `uniprot.main`,
     `tokenizer.train_cli.main` (a 4,096-piece BPE) and `tokenize_to_shards`
     into genbank/ and uniref100/ train and val shards; the training CLI on
     them with `--train_type mixed`, ctx 1024, B 32 (mini 16),
     `--checkpoint_freq 1 --remat_policy dots`: 4 steps, a checkpoint and 1
     resumed step, #1 launched 2 x 8 and #2 8 times a micro-batch; remat
     exact: one micro-batch with checkpoint_freq 0, 1 'full' and 1 'dots'
     at ctx 1024 (mini 16) and 2048 (mini 8, 5 EOS a row), bit for bit on
     the split pair (#4/#5), loss bit for bit and gradients within the
     training bar on the fused backward (#2/#3); the fused cross-entropy
     against the plain head (training bars, and its memory); the executed
     tile fractions (`kernel_skip_fractions`) against the tiles the
     kernels' counters report at ctx 1024, 2048 and 4096; and step time,
     tokens/s, peak allocated memory, mfu and mfu_executed of remat off /
     'full' / 'dots' with the plain head and the fused CE at ctx 1024, remat
     off / 'full' at ctx 4096 (mini 4 x 2), and ctx 4096 at mini 8 x 1 with
     'full' remat;
 14. the TAPE contact eval and DeePNAP, omnibiote-small at full width
     (dropout 0.1) from a checkpoint on disk: `run_contact_eval` with the
     8-block CNN on ProteinNet fixtures whose proteins span the buckets,
     one in each split at the top (961-1022 inner tokens, T = 1024, the
     only bucket that reaches #1 and #2), W-W pairs the contacts: finite
     metrics, both kernels launched, no other attention kernel; two
     fine-tune steps on the top-bucket sample on the kernels against the
     plain attention at dropout 0, in bf16 (losses, the encoder's and the
     head's first-step gradients, the predicted map's rows before the
     steps; the CNN's gradients and the map after them printed, since the
     random-init CNN amplifies bf16-sized differences of its input) and in
     fp32 (losses, every gradient, the map after the steps); ms a sample
     of a grad step and of `predict`
     at n = 1022, split into the CNN alone and the rest, and the grad
     step's peak memory, with the TF32 setting; `run_deepnap` with its CV
     (no attention kernel) and its pretraining steps/s at batch 256; a
     checkpoint cut into 4 `params.shard*.npz` files in the JAX package's
     pod layout, loaded bit for bit equal to its params.npz;
 15. multi-GPU modes at world size 1: a one-rank NCCL group (tcp
     rendezvous on 127.0.0.1), omnibiote-small at full width, bench.py's
     traffic (ctx 1024, B 32 as 16 x 2, 3 EOS a row, dropout 0.1): the
     sharded Trainer in 'replicated' and 'fsdp' on meshes (1,) and (1, 1)
     and in 'tp' and 'fsdp+tp' on (1, 1), 3 steps each against the plain
     Trainer on the same batches (loss, grad_norm, every parameter's
     update cosine: the fused backward's dq sums are not repeatable) and
     its #1/#2 launches; the split pair once (#4/#5): 'fsdp' (1,) against
     the plain Trainer bit for bit, then a pod-sharded checkpoint after
     step 3 from which a fresh trainer takes step 4 bit for bit as the
     unbroken run; `Encoder(mesh=)` against the single-device Encoder on
     the serving slice's sequences; tokens/s, the Trainer's peak memory and
     the collectives' device time (and its share) and host time for every
     mode and the plain Trainer;
 16. sequence parallelism (ring attention): #1-#5 with separate q and kv
     segment ids (a ring rotation's pair: the last block of 5-EOS rows cut
     into 2 blocks of 2048 or 4 of 1024 against the one before it, B 4, H 8, D 128,
     bf16 and fp32, dropout 0 and 0.1) against their plain versions, with
     skipping on against off bit for bit on the rows the ring weighs, and a
     distinct copy of one ids array against the array itself; the forward's
     time at the training shape with one ids array and with a copy as the
     kv ids; the flash ring body over N = 2 and 4 blocks of one sequence at
     B 4, T 4096, omnibiote-small's 8 heads of 128, bf16, in one process
     (NCCL refuses two ranks on one card), fused backward and split pair,
     against plain attention on the whole sequence at dropout 0 and against
     the plain ring body under dropout 0.1, with no skip bound computed
     inside a rotation; forward + backward times of one flash call on the
     whole sequence and of N = 1, 2 and 4, whole and in the kernels; the
     training CLI with --sharding sp at ctx 4096, omnibiote-small, on
     meshes (1,) and (1, 1) over a one-rank NCCL group (3 steps and a
     validation probe); the sp Trainer against the plain Trainer at dropout
     0 over 3 steps; the tokens/s and peak memory of both at dropout 0.1;
 17. pipeline parallelism (the GPipe schedule) over a one-rank NCCL group,
     omnibiote-small at full width, bench.py's traffic: the training CLI
     with --sharding pp on meshes (1,) and (1, 1) and --sharding fsdp+pp
     on (1, 1), 3 steps each with a validation probe, the pod-sharded
     checkpoint reloaded and one step resumed from it, #1 and #2 launched
     exactly steps x L x A (+ L a probe) times; the pp Trainer (1,)
     against the plain Trainer at dropout 0 on the split pair (losses, the
     #1/#4/#5 launches) and one step at dropout 0.1 (loss, every
     gradient's cosine, the gradient norm); the stage split: one
     micro-batch through the stage functions of S = 2 and 4 stages in turn
     against the whole model, forward bit for bit, gradients bit for bit on
     the split pair and within the dq tolerance on the fused backward; the
     tokens/s and peak memory of the pp Trainer against the plain one, with
     and without --checkpoint_freq 1;
 18. the pod planner (tools/gpu_pod_plan.py) against the card: for each
     anchor the peak allocated memory above what was allocated before the
     Trainer (the peaks that phase 13's lever runs and phase 17's pp Trainer
     at checkpoint_freq 0 recorded, else 2 steps here) against the plan's
     memory_bytes.total, measured / planned within 0.97-1.03: omnibiote-small
     at ctx 1024, 16 x 2, remat off / 'full' / 'dots' and off with the fused
     CE, at ctx 4096, 4 x 2, and the pp Trainer on (1,); and a held-out
     model no other phase trains (16 layers, d 2048, 16 heads of 128, ctx
     1024, 8 x 2, bf16 moments and gradients, 'full' remat; its #1 and #2
     launches counted, then both kernels against their plain versions at
     its shape with its segment ids and dropout 0.1); then the planner's
     2 x 8 fsdp+tp plan of that model, an estimate;
 19. head dim 256, and one head at any head dim up to 256: #1-#5 at D = 256
     (4 heads) against their plain versions in bf16 and fp32, dropout 0
     and 0.1, on dense, packed (3 and 5 EOS) and PAD-tail rows at T 1024
     and 2048, with bounds against the full walk bit for bit, the tiles
     walked against the bounds' count, the split pair twice and fused
     against split; flash_attention_lse with separate q and kv ids through
     autograd; one head at D = 96 and 32 with RoPE through the kernels of
     the next built head dim on zero-padded inputs, against the plain
     versions at the caller's D; each D = 256 kernel (#1-#9) timed at its
     path's shape beside its plain version, its bound and SDPA (and the
     SDPA backends that take the call alone); omnibiote-small with 4
     heads of 256 through the Encoder (bf16 and int8 against the plain
     attention, int8 against bf16; encode(mean) seq/s beside 8 heads of
     128) and through training (ctx 1024: micro-batch and step against
     plain, the CLI with --n_head 4, tokens/s beside 8 heads of 128; ctx
     2048: a step on the fused backward and on the split pair), with exact
     launch counts, and the per-head entry at D = 256;
 20. head dims past 256, and one head at any head dim: #1-#5 at D = 384,
     512 and 1024 (2 heads) against their plain versions in bf16 and fp32,
     dropout 0 and 0.1, on dense, packed (3 and 5 EOS) and PAD-tail rows at
     T 256 and 512, as phase 19 holds them (bounds on = off and a second
     forward launch bit for bit, the tiles walked, the split pair twice,
     fused against split, flash_attention_lse with separate q and kv
     ids; the bf16 forward on its wgmma kernel at D = 384 and 512, on the
     slice kernel at 1024); the bf16 backwards at D = 384 and 512 over the
     main paths' layouts at T 1024 and 2048 (the fused cluster; the split
     pair, with its routes, its per-head calls and its outputs the same
     bits with bounds on and off and at a second launch); #9
     against its plain version (its prologue
     bit for bit) at those head dims; one head at D = 320 and 600
     through the kernels of D = 384 and 640 on zero-padded inputs; then
     omnibiote-small with 2 heads of 512 as phase 19 runs 4 heads of 256:
     each D = 512 kernel timed at its path's shape, the Encoder (bf16,
     int8), training at ctx 1024 and 2048 with exact launch counts, the
     per-head entry, and seq/s and tokens/s beside phase 19's 8 heads of
     128 from the same run;
 21. a reference OmniBioTE checkpoint: a .pt in the reference's layout
     at omnibiote-small full width (seeded weights, the freqs_cis RoPE
     buffers, {"model": {"module." + name: tensor}, "step": 7}) through
     `python -m omnibiote_tpu_torch.utils.torch_convert` in a subprocess
     (its size and the seconds to convert), the converted tensors bit for
     bit against the seed's; `Encoder.from_checkpoint` on the converted
     directory, on the card by default, over the serving slice's 64
     sequences with every pooling (#1, 8 a batch), bit for bit against an
     Encoder over the same state loaded in memory and against the plain
     attention; the same with int8 weights and attention (#9) against the
     bf16 embeddings and the plain int8 attention; the FASTA CLI on the
     directory; encode(mean) seq/s at B=32, T=1024 beside phase 3's; the
     bare, '_orig_mod.'-prefixed and pickled-module (a stand-in module class
     whose head comes from a stub `mup`) forms through the CLI at a small
     width;
 22. flash_attention and int8_flash_attention called directly at T 192,
     320 and 1000 on CUDA tensors (rows zero-padded to the kernels' T
     multiple, the pad rows on a segment id of their own): #1-#5 at B=2, 8
     heads of 128 (bf16, fp32) and 2 heads of 512 (bf16), dense, packed and
     PAD-tail rows, RoPE, dropout 0 and 0.1, the forward, the fused
     backward with one kv block and with several, and the split pair, each
     against its plain version at the unpadded T; one head at D = 96; the
     per-head entry at T = 192; #9 at T = 192 and 320; each entry's time
     at T = 192 beside T = 256 (taken after phase 10, before the first
     other profiler session: after the multi-GPU phases the profiler of
     the process recorded no kernel);
 23. the fp32 path at omnibiote-small full width and depth (compute_dtype
     float32, fp32 parameters, seeded weights), from a checkpoint whose
     meta.json says float32: `obt-torch-encode` on the serving slice's
     sequences and `obt-torch-train` for 2 steps over synthetic shards
     (bf16: the CLI has no dtype flag), each in a subprocess as its
     console-script wrapper runs it (`sys.exit(main())`); the Encoder from
     the checkpoint at B=32, T=1024 against the plain attention, and with
     int8 weights and attention (#9's fp32 instance) against the plain int8
     attention and the fp32 embeddings; one micro-batch at dropout 0 on the
     fused backward and on the split pair against the plain attention
     (loss, every gradient, grad_norm); the Trainer at ctx 1024 (16 x 2,
     dropout 0.1, 3 EOS a row) fused and split, one step at ctx 2048 (8 x
     2) through #3, with exact launch counts, tokens/s and peak memory;
     encode(mean) seq/s beside phase 3's bf16 rate; then each fp32 kernel
     (#1-#9) at its row's shape with skipping and over every tile beside
     its plain version, its bound at the FP32 rate (67 TFLOP/s) or its
     bytes and SDPA on the same fp32 inputs (its backends, TF32 off), the
     split pair's dq a second time bit for bit, the per-head entry's path;
 24. prints the card's name and power limit, one JSON line of kernel
     numbers (a row of each phase-19 kernel at D = 256, of each phase-20
     kernel at D = 512 and of each phase-23 fp32 instance beside the 13
     rows; phase 21's and 22's launches added to the rows of their kernels
     at their head dims), and last the line {"ok": true, "device": {...}}.

Any failed check raises, and the script then exits non-zero without the
last line. Without a CUDA device, or without the package beside it, it
fails at once.
"""
import json
import math
import os
import pickle
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, no sparsity): bf16 and int8
# tensor cores, FP32 on the CUDA cores (FFMA: the yardstick `bound_ffma_ms`
# of the 3xTF32 kernels), HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
# dense TF32 on the tensor cores; the fp32 attention kernels run three such
# products (3xTF32) for each of the function's
PEAK_TF32_FLOPS = 495e12
PEAK_INT8_OPS = 1979e12
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


def graph_ms(fn, iters=20, reps=5):
    """Mean device time of fn() in ms without the host's cost of a call: CUDA
    events around `reps` replays of a CUDA graph of `iters` calls (for
    kernels of tens of microseconds, which a slow host cannot launch as fast
    as the card runs them)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (reps * iters)
    del graph
    return ms


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
    # one line a kernel instance: template arguments, registers, spills;
    # and the instances ptxas serialised (its C7511 "wgmma.mma_async
    # instructions are serialized" note)
    spills, serialised = {}, set()
    kernel_re = (r"_ZN[\w]*?\d+(mh_\w+?|rope_rows_\w+?|dq_epilogue|dots_wgmma|dots_n_wgmma|"
                 r"scores_wgmma)ILi(\d+)E((?:Lb[01]E|Li\d+E)*)")
    # the kernels past D = 256 (wide_attention.cuh, int8_fwd_wide): element
    # type first, the head dim a run-time size
    wide_re = (r"Compiling entry function '_ZN[\w]*?\d+((?:mh_fwd|mh_bwd|mh_bwd_dq|int8_fwd|"
               r"quant_qk)_wide)I(f|13__nv_bfloat16)((?:Lb[01]E)*)")
    # the int8 wgmma kernel past 256: output type, segment flag, head dim
    # (mh_fwd_wide_wgmma<D, DROP, BOUNDS> reads as the kernels above do)
    wide8_re = (r"Compiling entry function '_ZN[\w]*?\d+(int8_fwd_wide_wgmma)I(f|13__nv_bfloat16)"
                r"Lb([01])ELi(\d+)E")
    for name, log in logs.items():
        entry = spill = stack = None
        for line in log.splitlines():
            mw = re.search(wide_re, line)
            m8w = re.search(wide8_re, line)
            m = None if mw or m8w else re.search(r"Compiling entry function '" + kernel_re, line)
            m8 = re.search(r"Compiling entry function '_ZN[\w]*?\d+(int8_fwd|quant_qk|"
                           r"quant_v)I(f|i|13__nv_bfloat16)((?:Lb[01]E)*)(?:Li(\d+)E)?E", line)
            if "C7511" in line:
                mc = re.search(kernel_re, line)
                serialised.add(f"{name}: {mc.group(1) if mc else line.strip()}")
            elif mw:
                ty = "float" if mw.group(2) == "f" else "bf16"
                entry = f"{mw.group(1)}<{', '.join([ty, *re.findall(r'Lb([01])E', mw.group(3))])}>"
            elif m8w:
                ty = "float" if m8w.group(2) == "f" else "bf16"
                entry = f"{m8w.group(1)}<{ty}, {m8w.group(3)}, {m8w.group(4)}>"
            elif m:
                args = re.findall(r"L[bi](\d+)E", m.group(3))
                entry = f"{m.group(1)}<{', '.join([m.group(2), *args])}>"
            elif m8:
                ty = {"f": "float", "i": "int"}.get(m8.group(2), "bf16")
                flags = re.findall(r"Lb([01])E", m8.group(3))
                entry = f"{m8.group(1)}<{', '.join([ty, *flags, *filter(None, [m8.group(4)])])}>"
            elif "spill stores" in line:
                spill = re.search(r"(\d+) bytes spill stores", line).group(1)
                stack = re.search(r"(\d+) bytes stack frame", line).group(1)
            elif "warning" in line.lower():
                print(f"  {name}: {line.strip()[:240]}")
            elif "registers" in line and entry is not None:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                if entry.startswith(("mh_", "int8_fwd", "quant_", "dots", "scores")):
                    print(f"  {name}: {entry}: {regs} registers, {spill} bytes of spill "
                          f"stores, {stack} bytes of stack frame")
                    spills[f"{name}: {entry}"] = int(spill)
                entry = None
    # a spill makes ptxas serialise the wgmma products around it: the
    # backward's wgmma kernels (fused, dkv and dq) and the wgmma probes must
    # show none, and the probes no serialised products either
    wgmma_kernels = ("mh_bwd_fused_bf16", "mh_bwd_d256_bf16", "mh_bwd_dq_wgmma", "mh_bwd_pair",
                     "mh_bwd_dq_cta", "dots_wgmma", "dots_n_wgmma", "scores_wgmma")
    spilled = {k: v for k, v in spills.items() if k.split(": ")[1].startswith(wgmma_kernels) and v}
    check(not spilled, f"wgmma instances spill: {spilled}")
    # and no bf16 instance of the kernels past D = 256, nor any instance of
    # the wgmma forwards there
    spilled = {k: v for k, v in spills.items() if ("_wide<bf16" in k or "_wide_wgmma<" in k) and v}
    check(not spilled, f"bf16 or wgmma instances past D = 256 spill: {spilled}")
    # nor any fp32 instance of #1-#5 up to D = 256: the forward, the fused
    # backward (also the dkv kernel, without dq) and the dq kernel, at D = 64,
    # 128 and 256 with and without dropout
    f32 = {k: v for k, v in spills.items()
           if k.split(": ")[1].startswith(("mh_fwd_f32<", "mh_bwd_f32<", "mh_bwd_dq_f32<"))}
    check(len(f32) == 24, f"the build printed {len(f32)} fp32 instances, want 24: {sorted(f32)}")
    check(not any(f32.values()), f"fp32 instances spill: {({k: v for k, v in f32.items() if v})}")
    print(f"  fp32 instances (mh_fwd_f32, mh_bwd_f32 with and without dq, mh_bwd_dq_f32; "
          f"D = 64, 128, 256, dropout 0 and 1): {len(f32)}, 0 bytes of spill stores")
    # the fp32 dq kernel's products are tf32 mma.sync (HMMA ... TF32 in its
    # SASS) and none is left on FFMA
    sass = subprocess.run([os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump"), "-sass",
                           _kernels._so_path("mh_flash_bwd_dq")], capture_output=True, text=True,
                          check=True).stdout
    dq_sass = {}
    for part in sass.split("Function : ")[1:]:
        fn = part.split(None, 1)[0]
        if "mh_bwd_dq_f32" in fn:
            dq_sass[fn] = (len(re.findall(r"HMMA\.[\w.]*TF32", part)),
                           len(re.findall(r"\bFFMA\b", part)))
    check(len(dq_sass) == 6 and all(h > 0 and f == 0 for h, f in dq_sass.values()),
          f"the fp32 dq instances' SASS (tf32 HMMA, FFMA): {sorted(dq_sass.values())}")
    print(f"  mh_bwd_dq_f32 SASS, 6 instances: tf32 HMMA "
          f"{sorted(h for h, _ in dq_sass.values())}, FFMA 0")
    print(f"  instances with wgmma products serialised by ptxas (C7511): "
          f"{sorted(serialised) or 'none'}")
    check(not any(k.split(": ")[1].startswith(wgmma_kernels[3:]) for k in serialised),
          f"ptxas serialised the products of the cluster backward or a wgmma probe: "
          f"{sorted(serialised)}")
    check(not any("wide_wgmma" in k for k in serialised),
          f"ptxas serialised the products of a wgmma forward past 256: {sorted(serialised)}")
    # the bf16 forward's and backward kernels' CTAs: 384 threads, setmaxnreg
    # 24 (producer) / 240 (consumers), dynamic shared memory as their launches
    # ask
    for name, kernel in (("mh_flash_fwd", "mh_fwd_bf16"), ("mh_flash_bwd", "mh_bwd_fused_bf16"),
                         ("mh_flash_bwd_dkv", "mh_bwd_fused_bf16 without dq"),
                         ("mh_flash_bwd_dq", "mh_bwd_dq_wgmma")):
        smem_bytes = getattr(_kernels.load_library(name), f"obt_{name}_smem_bytes")
        if name == "mh_flash_fwd":
            past = (f"; mh_fwd_wide_wgmma D=384 {smem_bytes(384)} bytes, D=512 {smem_bytes(512)} "
                    f"bytes; past 512 (mh_fwd_wide, any D) {smem_bytes(1024)} bytes")
        elif name == "mh_flash_bwd":
            past = (f"; mh_bwd_pair D=384 {smem_bytes(384)} bytes, D=512 {smem_bytes(512)} "
                    f"bytes; past 512 (mh_bwd_wide, any D) {smem_bytes(1024)} bytes")
            check(max(smem_bytes(384), smem_bytes(512)) <= 232448,
                  "mh_bwd_pair takes more than 227 KB of shared memory a CTA")
        else:
            pair = "mh_bwd_pair without dq" if name == "mh_flash_bwd_dkv" else "mh_bwd_dq_cta"
            past = (f"; {pair} D=384 {smem_bytes(384)} bytes, D=512 {smem_bytes(512)} bytes; "
                    f"past 512 (the *_wide kernel, any D) {smem_bytes(1024)} bytes")
            check(max(smem_bytes(384), smem_bytes(512)) <= 232448,
                  f"{pair} takes more than 227 KB of shared memory a CTA")
        print(f"  {name}: {kernel} dynamic shared memory a CTA: " + ", ".join(
            f"D={d} {smem_bytes(d)} bytes" for d in (64, 128, 256)) + past)
    int8_smem = _kernels.load_library('int8_flash_fwd').obt_int8_flash_fwd_smem_bytes
    print(f"  int8_flash_fwd: int8_fwd dynamic shared memory a CTA: D=128 {int8_smem(128)} "
          f"bytes, D=256 {int8_smem(256)} bytes; int8_fwd_wide_wgmma D=384 {int8_smem(384)} "
          f"bytes, D=512 {int8_smem(512)} bytes; int8_fwd_wide past 512 {int8_smem(1024)} "
          f"bytes (static)")


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


def _visible_pairs(seg, B, T):
    """The (q, k) pairs of one call that attend: all B*T*T without segment
    ids, else the pairs with equal ids (what this run's data needs; a
    kernel that skips masked tiles does no more than a tile's rounding
    above it)."""
    if seg is None:
        return float(B) * T * T
    return float(sum((seg[b, :, None] == seg[b, None, :]).sum().item()
                     for b in range(B)))


def _bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _attn_bound(B, T, H, D, pairs=None, itemsize=2, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by) of one bf16 forward call with RoPE: the larger
    of its operations (two products over `pairs` (q, k) pairs, default all
    B*T*T) over the bf16 peak and its bytes (q, k, v and the rope tables
    read once, o and lse2 written once) over HBM bandwidth; an fp32 call
    with itemsize 4 and the FP32 peak."""
    pairs = float(B) * T * T if pairs is None else pairs
    nbytes = 4 * B * T * H * D * itemsize + B * T * H * 4 + 2 * T * (D // 2) * 4
    return _bound(4.0 * pairs * H * D, nbytes, peak)


def kernel_phase():
    """The forward kernel without dropout (the serving path) against its
    plain version, and timed and held against it at the serving shape.
    Returns max |do| at that shape."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops.flash_attention import (
        KERNEL_KV_TILE, SegmentBounds, mh_flash_forward, mh_flash_forward_plain)

    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)
    cases = [(4, 1024, dt, lay, D, 0.0) for dt in ("bfloat16", "float32")
             for lay in ("packed", "padded", "dense")]
    cases += [(32, 384, "bfloat16", "padded", D, 0.0), (32, 1024, "bfloat16", "dense", D, 0.0)]
    # head dim 64: no main path has it, but the bf16 kernel is built for it
    cases += [(4, 1024, "bfloat16", "packed", 64, rate) for rate in (0.0, TRAIN_DROPOUT)]
    for i, (B, T, dtype, layout, hd, rate) in enumerate(cases):
        tdt = getattr(torch, dtype)
        q, k, v, seg, rope = _attn_inputs(B, T, H, hd, tdt, layout, seed=i)
        kw = dict(scale=1.0 / math.sqrt(hd), dropout_rate=rate, seed=0x51ED + i)
        o, lse = mh_flash_forward(q, k, v, seg, rope, **kw)
        torch.cuda.synchronize()
        po, plse = mh_flash_forward_plain(q, k, v, seg, rope, **kw,
                                          block_kv=KERNEL_KV_TILE[tdt])
        check(torch.isfinite(o.float()).all() and torch.isfinite(lse).all(),
              f"non-finite kernel output at {(B, T, dtype, layout)}")
        err_o = (o.float() - po.float()).abs().max().item()
        err_l = (lse - plse).abs().max().item()
        rt, at = TOL[dtype]["o"]
        ok_o = torch.allclose(o.float(), po.float(), rtol=rt, atol=at)
        rl, al = TOL[dtype]["lse"]
        ok_l = torch.allclose(lse, plse, rtol=rl, atol=al)
        print(f"kernel vs plain B={B} T={T} D={hd} {dtype:8s} {layout:6s} dropout {rate}: "
              f"max|do| {err_o:.3e} (rtol {rt}, atol {at}) "
              f"max|dlse2| {err_l:.3e} (rtol {rl}, atol {al})")
        check(ok_o and ok_l, f"kernel disagrees with its plain version at "
              f"{(B, T, hd, dtype, layout, rate)}")
        del q, k, v, o, lse, po, plse

    # timing at the main path's shape: encode at B=32, T=1024, bf16, no mask
    B, T = 32, 1024
    q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 99)
    ms = cuda_ms(lambda: mh_flash_forward(q, k, v, None, rope, scale=scale), 20)
    plain_ms = cuda_ms(lambda: mh_flash_forward_plain(
        q, k, v, None, rope, scale=scale), 5, warmup=1)
    serving_err = _hold_fwd(
        mh_flash_forward(q, k, v, None, rope, scale=scale),
        mh_flash_forward_plain(q, k, v, None, rope, scale=scale,
                               block_kv=KERNEL_KV_TILE[torch.bfloat16]),
        "bfloat16", f"the serving shape B={B} T={T}")
    qr, kr = apply_rope_half(q, k, *rope)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (qr, kr, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 20)
    bound_ms, bound_by = _attn_bound(B, T, H, D)
    # the padded layout the masked encode gives, beside its SDPA with the
    # boolean mask
    _, _, _, pseg, _ = _attn_inputs(B, T, H, D, torch.bfloat16, "padded", 98)
    ms_pad = cuda_ms(lambda: mh_flash_forward(q, k, v, pseg, rope, scale=scale), 20)
    pb = SegmentBounds(pseg)
    ms_pad_skip = cuda_ms(lambda: mh_flash_forward(
        q, k, v, pseg, rope, scale=scale, segment_skip=True, bounds=pb), 20)
    mask = (pseg[:, :, None] == pseg[:, None, :])[:, None]
    library_pad = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale), 20)
    # host time of one call (wrapper, tensor maps, launch), the calls
    # enqueued back to back well ahead of the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        mh_flash_forward(q, k, v, None, rope, scale=scale)
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    tflops = 4.0 * B * T * T * H * D / (ms * 1e-3) / 1e12
    print(f"mh_flash_fwd B={B} T={T} H={H} D={D} bf16 dense: kernel {ms:.4f} ms "
          f"({tflops:.1f} TFLOP/s; host {host_us:.1f} us a call), plain {plain_ms:.4f} ms, SDPA "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); padded "
          f"(row lengths uniform in [T/8, T)): kernel {ms_pad_skip:.4f} ms with "
          f"skipping as the Encoder runs it, {ms_pad:.4f} ms without, SDPA with "
          f"mask {library_pad:.4f} ms; kernel vs plain at this shape max|do| "
          f"{serving_err:.3e}")
    return serving_err


# Backward kernel vs its plain version, relative to max|g| of the plain
# gradient: fp32 differs in the order of fp32 sums (dq's atomics add in an
# order that changes from run to run) and in exp2f's last bits; in bf16 the
# outputs are rounded to bf16 (2^-9 of the largest value) and an fp32
# difference can flip the bf16 rounding of a p_drop or ds operand.
BWD_TOL = {"bfloat16": 1e-2, "float32": 1e-4}
# The training shape of bench.py (mini-batch 16, ctx 1024, omnibiote-small
# heads) and its dropout.
TRAIN_SHAPE = dict(B=16, T=1024, H=8, D=128)
TRAIN_DROPOUT = 0.1


def _bwd_bound(B, T, H, D, pairs=None, kind="fused", itemsize=2, peak=PEAK_BF16_FLOPS):
    """(bound_ms, bound_by) of one bf16 backward call over `pairs` (q, k)
    pairs (default all B*T*T). fused: five products (10 flops a pair and
    head dim) and the bytes of q, k, v, do, dq, dk, dv (bf16), lse2 and di
    (fp32), each once; dkv: four products, no dq; dq: three products, no dk
    or dv. The fused kernel's fp32 dq scratch is its own design's traffic,
    not the function's, and is not counted. Operations over the bf16 peak
    against bytes over HBM bandwidth; an fp32 call with itemsize 4 and the
    FP32 peak."""
    pairs = float(B) * T * T if pairs is None else pairs
    n_prod, n_tensors = {"fused": (5, 7), "dkv": (4, 6), "dq": (3, 5)}[kind]
    nbytes = n_tensors * B * T * H * D * itemsize + 2 * B * T * H * 4
    return _bound(2.0 * n_prod * pairs * H * D, nbytes, peak)


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp_min(1e-30)).item()


def _abs_err(got, want):
    return (got.float() - want.float()).abs().max().item()


def _hold_fwd(got, want, dtype, what):
    """Forward (o, lse2) of a kernel against its plain version at TOL;
    returns max |do|."""
    import torch
    (rt, at), (rl, al) = TOL[dtype]["o"], TOL[dtype]["lse"]
    check(torch.allclose(got[0].float(), want[0].float(), rtol=rt, atol=at)
          and torch.allclose(got[1], want[1], rtol=rl, atol=al),
          f"forward kernel disagrees with its plain version at {what}")
    return _abs_err(got[0], want[0])


def _hold_bwd(got, want, dtype, what):
    """Gradients of a backward kernel against the plain ones at BWD_TOL;
    returns (max |d| / max |g|, max |d|) over the tensors."""
    import torch
    check(all(torch.isfinite(g.float()).all() for g in got),
          f"non-finite backward output at {what}")
    rel = max(_rel_err(g, w) for g, w in zip(got, want))
    check(rel <= BWD_TOL[dtype], f"backward kernel disagrees with its plain "
          f"version at {what}: {rel:.2e} > {BWD_TOL[dtype]}")
    return rel, max(_abs_err(g, w) for g, w in zip(got, want))


def train_kernel_phase():
    """Both kernels of the training path against their plain versions
    (forward with dropout, backward with and without), then timed at the
    training shape. Returns the two rows of the kernels line."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops.flash_attention import (
        KERNEL_KV_TILE, KERNEL_TILES, SegmentBounds, mh_flash_backward,
        mh_flash_backward_kernel, mh_flash_backward_plain, mh_flash_bwd_dkv_kernel,
        mh_flash_bwd_dq_kernel, mh_flash_forward, mh_flash_forward_plain)

    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)
    cases = [(4, 1024, dt, lay, D) for dt in ("bfloat16", "float32")
             for lay in ("packed", "padded", "dense")] + [(2, 2048, "bfloat16", "packed", D)]
    # head dim 64: no main path has it, but the bf16 kernels are built for it
    cases += [(4, 1024, "bfloat16", "packed", 64)]
    for i, (B, T, dtype, layout, hd) in enumerate(cases):
        tdt = getattr(torch, dtype)
        sc = 1.0 / math.sqrt(hd)
        q, k, v, seg, rope = _attn_inputs(B, T, H, hd, tdt, layout, seed=100 + i)
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        do = torch.randn(B, T, H, hd, generator=gen, device="cuda").to(tdt)
        seed = 0x9E3779B97F4A7C15 + i
        rt, at = TOL[dtype]["o"]
        rl, al = TOL[dtype]["lse"]
        if T == 1024:
            o, lse = mh_flash_forward(q, k, v, seg, rope, scale=sc,
                                      dropout_rate=TRAIN_DROPOUT, seed=seed)
            torch.cuda.synchronize()
            po, plse = mh_flash_forward_plain(
                q, k, v, seg, rope, scale=sc, block_kv=KERNEL_KV_TILE[tdt],
                dropout_rate=TRAIN_DROPOUT, seed=seed)
            check(torch.isfinite(o.float()).all() and torch.isfinite(lse).all(),
                  f"non-finite forward output at {(B, T, dtype, layout)}")
            err_o = (o.float() - po.float()).abs().max().item()
            print(f"fwd dropout {TRAIN_DROPOUT} vs plain B={B} T={T} D={hd} {dtype:8s} "
                  f"{layout:6s}: max|do| {err_o:.3e} (rtol {rt}, atol {at}) "
                  f"max|dlse2| {(lse - plse).abs().max().item():.3e}")
            check(torch.allclose(o.float(), po.float(), rtol=rt, atol=at)
                  and torch.allclose(lse, plse, rtol=rl, atol=al),
                  f"forward with dropout disagrees at {(B, T, dtype, layout)}")
        for rate in ((0.0, TRAIN_DROPOUT) if T == 1024 else (TRAIN_DROPOUT,)):
            po, plse = mh_flash_forward_plain(q, k, v, seg, rope, scale=sc,
                                              dropout_rate=rate, seed=seed)
            di = (po.float() * do.float()).sum(-1)
            bargs = (q, k, v, do, plse, di, seg, rope)
            bkw = dict(scale=sc, dropout_rate=rate, seed=seed)
            got = mh_flash_backward_kernel(*bargs, **bkw)
            # the split pair: the same function in two kernels
            dk_s, dv_s = mh_flash_bwd_dkv_kernel(*bargs, **bkw)
            split = (mh_flash_bwd_dq_kernel(*bargs, **bkw), dk_s, dv_s)
            torch.cuda.synchronize()
            want = mh_flash_backward_plain(*bargs, **bkw)
            errs = [_rel_err(g, w) for g, w in zip(got, want)]
            errs_s = [_rel_err(g, w) for g, w in zip(split, want)]
            print(f"bwd dropout {rate} vs plain B={B} T={T} D={hd} {dtype:8s} {layout:6s}: "
                  f"max|d|/max|g| fused dq {errs[0]:.2e} dk {errs[1]:.2e} dv {errs[2]:.2e}, "
                  f"split dq {errs_s[0]:.2e} dk {errs_s[1]:.2e} dv {errs_s[2]:.2e} "
                  f"(tolerance {BWD_TOL[dtype]})")
            check(all(torch.isfinite(g.float()).all() for g in (*got, *split)),
                  f"non-finite backward output at {(B, T, dtype, layout, rate)}")
            check(max(errs) <= BWD_TOL[dtype],
                  f"backward kernel disagrees at {(B, T, hd, dtype, layout, rate)}")
            check(max(errs_s) <= BWD_TOL[dtype],
                  f"split backward disagrees at {(B, T, hd, dtype, layout, rate)}")
            del got, want, split, dk_s, dv_s
        del q, k, v, do

    # a bf16 call at a T off the kernel's 128-row multiple is refused at the
    # wrapper: no kernel, no plain version
    x = torch.zeros(1, 192, H, D, dtype=torch.bfloat16, device="cuda")
    rows = torch.zeros(1, 192, H, device="cuda")
    refused = None
    try:
        mh_flash_backward_kernel(x, x, x, x, rows, rows, scale=scale)
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "multiple of 128" in refused,
          f"the bf16 fused backward at T=192: {refused or 'ran'}")
    print(f"bf16 fused backward at T=192 refused: {refused}")

    # timing at the training shape: bf16, RoPE, bench.py's rows (three EOS
    # each), dropout 0.1, segment skipping on as the main path has it (and
    # off beside it: every tile walked)
    B, T = TRAIN_SHAPE["B"], TRAIN_SHAPE["T"]
    q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 77)
    seg = torch.from_numpy(next(bench_batches(B, T, seed=77))["segments"]).cuda()
    bounds = SegmentBounds(seg)
    gen = torch.Generator(device="cuda").manual_seed(78)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    seed, rate = 12345, TRAIN_DROPOUT
    fwd = lambda: mh_flash_forward(q, k, v, seg, rope, scale=scale,
                                   dropout_rate=rate, seed=seed,
                                   segment_skip=True, bounds=bounds)
    fwd_ms = cuda_ms(fwd, 20)
    fwd_noskip_ms = cuda_ms(lambda: mh_flash_forward(
        q, k, v, seg, rope, scale=scale, dropout_rate=rate, seed=seed), 20)
    fwd_plain_ms = cuda_ms(lambda: mh_flash_forward_plain(
        q, k, v, seg, rope, scale=scale, dropout_rate=rate, seed=seed), 3, warmup=1)
    o, lse = fwd()
    di = (o.float() * do.float()).sum(-1)
    bwd = lambda: mh_flash_backward(
        q, k, v, do, lse, di, seg, rope, scale=scale, dropout_rate=rate,
        seed=seed, segment_skip=True, bounds=bounds)
    bwd_ms = cuda_ms(bwd, 20)
    # both kernels against their plain versions at this shape, as the main
    # path calls them; the fused backward's walk against its bounds
    shape = f"the training shape B={B} T={T}"
    bq, bkv = KERNEL_TILES["fused"][torch.bfloat16]
    lo, hi = bounds.get(bkv, bq)
    n_walk = H * int((hi - lo + 1).sum())
    _walked(lambda c: mh_flash_backward_kernel(
        q, k, v, do, lse, di, seg, rope, scale=scale, dropout_rate=rate, seed=seed,
        tile_bounds=(lo, hi), tile_count=c), n_walk, f"fused backward at {shape}")
    worst_f = _hold_fwd((o, lse), mh_flash_forward_plain(
        q, k, v, seg, rope, scale=scale, dropout_rate=rate, seed=seed,
        block_kv=KERNEL_KV_TILE[torch.bfloat16]), "bfloat16", shape)
    rel_b, worst_b = _hold_bwd(bwd(), mh_flash_backward_plain(
        q, k, v, do, lse, di, seg, rope, scale=scale, dropout_rate=rate,
        seed=seed), "bfloat16", shape)
    print(f"kernels vs plain at {shape} bf16 dropout {rate}: fwd max|do| "
          f"{worst_f:.3e} (rtol, atol {TOL['bfloat16']['o']}), bwd max|d|/max|g| "
          f"{rel_b:.2e} (tolerance {BWD_TOL['bfloat16']}), max|d| {worst_b:.3e}")
    bwd_noskip_ms = cuda_ms(lambda: mh_flash_backward_kernel(
        q, k, v, do, lse, di, seg, rope, scale=scale, dropout_rate=rate,
        seed=seed), 20)
    bwd_plain_ms = cuda_ms(lambda: mh_flash_backward_plain(
        q, k, v, do, lse, di, seg, rope, scale=scale, dropout_rate=rate,
        seed=seed), 3, warmup=1)
    # the same calls without dropout: what the Philox draw costs
    fwd_nodrop_ms = cuda_ms(lambda: mh_flash_forward(q, k, v, seg, rope, scale=scale), 20)
    bwd_nodrop_ms = cuda_ms(lambda: mh_flash_backward_kernel(
        q, k, v, do, lse, di, seg, rope, scale=scale), 20)
    # library yardsticks: SDPA with dropout (dense; it has no segment ids),
    # and its backward as (forward + backward) - forward through autograd
    qr, kr = apply_rope_half(q, k, *rope)
    qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (qr, kr, v))
    doh = do.transpose(1, 2).contiguous()
    sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, dropout_p=rate, scale=scale)
    with torch.no_grad():
        lib_fwd_ms = cuda_ms(sdpa, 20)
    lib_fb_ms = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), 20)
    lib_bwd_ms = lib_fb_ms - lib_fwd_ms
    pairs = _visible_pairs(seg, B, T)
    fwd_bound, fwd_by = _attn_bound(B, T, H, D, pairs)
    bwd_bound, bwd_by = _bwd_bound(B, T, H, D, pairs)
    print(f"training shape B={B} T={T} H={H} D={D} bf16, 3 EOS a row (visible "
          f"share of (q, k) pairs {pairs / (B * T * T):.4f}; the fused backward walks "
          f"{n_walk} of {H * B * (T // bq) * (T // bkv)} {bkv}x{bq} tiles), dropout {rate}: "
          f"mh_flash_fwd {fwd_ms:.4f} ms with skipping, {fwd_noskip_ms:.4f} "
          f"without (plain {fwd_plain_ms:.4f}, SDPA dense {lib_fwd_ms:.4f}, bound "
          f"{fwd_bound:.4f} {fwd_by} over visible pairs, "
          f"{_attn_bound(B, T, H, D)[0]:.4f} over all); mh_flash_bwd {bwd_ms:.4f} "
          f"ms with skipping, {bwd_noskip_ms:.4f} without "
          f"({10.0 * B * T * T * H * D / (bwd_noskip_ms * 1e-3) / 1e12:.1f} "
          f"TFLOP/s over all pairs; plain {bwd_plain_ms:.4f}, SDPA dense backward "
          f"{lib_bwd_ms:.4f}, bound {bwd_bound:.4f} {bwd_by} over visible pairs, "
          f"{_bwd_bound(B, T, H, D)[0]:.4f} over all); without dropout or "
          f"skipping: mh_flash_fwd {fwd_nodrop_ms:.4f} ms, mh_flash_bwd "
          f"{bwd_nodrop_ms:.4f} ms")
    fwd_row = {"name": "mh_flash_fwd", "route": "cuda",
               "source": "omnibiote_tpu_torch/ops/csrc/mh_flash_fwd.cu",
               "replaces": "omnibiote_tpu/ops/flash_attention.py:545",
               "launches": None, "max_abs_err": worst_f, "ms": fwd_ms,
               "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound,
               "bound_by": fwd_by, "library_ms": lib_fwd_ms}
    bwd_row = {"name": "mh_flash_bwd", "route": "cuda",
               "source": "omnibiote_tpu_torch/ops/csrc/mh_flash_bwd.cu",
               "replaces": "omnibiote_tpu/ops/flash_attention.py:965",
               "launches": None, "max_abs_err": worst_b, "ms": bwd_ms,
               "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound,
               "bound_by": bwd_by, "library_ms": lib_bwd_ms}
    return fwd_row, bwd_row


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


SERVING_BATCH = 32
SERVING_RUNS = [(m, masked) for m in ("mean", "first", "last", "max")
                for masked in (True, False)]


def _encode_rate(model, x, label, steps=16):
    """encode(model, x, "mean") seq/s over `steps` batches after two of
    warm-up, with the peak allocated memory of the window."""
    import torch
    from omnibiote_tpu_torch import encode

    for _ in range(2):
        encode(model, x, "mean")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    for _ in range(steps):
        e = encode(model, x, "mean")
    torch.cuda.synchronize()
    dt = time.time() - t0
    check(bool(torch.isfinite(e.float()).all()), f"non-finite encode output ({label})")
    sps = steps * x.shape[0] / dt
    print(f"encode(mean) B={x.shape[0]} T={x.shape[1]} {label}: {sps:.1f} seq/s "
          f"({1e3 * dt / steps:.3f} ms per batch), peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return sps


def slice_phase(workdir):
    """The bf16 serving slice. Returns (launches of its main path, what the
    int8 serving slice reuses: tokenizer, model, sequences, embeddings,
    the throughput batch)."""
    import random
    import torch
    from omnibiote_tpu_torch import init_params, preset
    from omnibiote_tpu_torch.api import Encoder
    from omnibiote_tpu_torch.ops import _kernels
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

    batch_size = SERVING_BATCH
    n_batches = -(-len(seqs) // batch_size)
    runs = SERVING_RUNS
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
    worst = 1.0
    with _plain_attention():
        for method, masked in runs:
            ref = enc.encode_sequences(seqs, method=method,
                                       batch_size=batch_size, mask_padding=masked)
            a, b = torch.from_numpy(outs[(method, masked)]), torch.from_numpy(ref)
            cos = torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=1)
            worst = min(worst, cos.min().item())
            check(cos.min().item() >= MIN_COSINE,
                  f"{method}/{masked}: min row cosine {cos.min().item():.6f} "
                  f"vs the plain attention < {MIN_COSINE}")
    check(_kernels.LAUNCHES == launches, "the plain run launched the kernel")
    print(f"slice: kernel path vs plain attention, min row cosine {worst:.7f} "
          f"(threshold {MIN_COSINE})")

    # encode throughput at ctx 1024, as bench.py times it
    x = torch.randint(20, 65000, (batch_size, cfg.block_size),
                      generator=gen, device="cuda")
    rate = _encode_rate(model, x, "bf16")
    return launches, dict(sp=sp, tok_path=tok_path, model=model, seqs=seqs,
                          outs=outs, x=x, rate=rate)


# ---------------------------------------------------------------------------
# 4. training slice
# ---------------------------------------------------------------------------

# Kernel run vs plain run of the training path (bf16 compute, the same
# dropout masks): the forward's bf16 roundings differ by an ulp here and
# there and the backward's dq sums in another order, so the loss is held to
# 1e-2, every parameter gradient to a cosine of 0.99 with the plain run's,
# and the step's grad_norm to a relative 1e-2.
TRAIN_LOSS_ATOL = 1e-2
TRAIN_GRAD_COS = 0.99
TRAIN_GNORM_RTOL = 1e-2


def bench_batches(batch, ctx, seed, n_eos=3):
    """bench.py's training batches: random tokens, three EOS a row at
    positions in [32, ctx) (bench_longctx.py's rows with n_eos=5)."""
    import numpy as np
    from omnibiote_tpu_torch.config import EOS_TOKEN
    from omnibiote_tpu_torch.ops.segments import segment_ids_np

    rng = np.random.default_rng(seed)
    while True:
        toks = rng.integers(20, 65000, size=(batch, ctx)).astype(np.int32)
        for r in range(batch):
            toks[r, rng.integers(32, ctx, size=n_eos)] = EOS_TOKEN
        yield {"tokens": toks, "segments": segment_ids_np(toks)}


def _plain_attention():
    """Context: both attention directions on their plain versions."""
    import contextlib
    from omnibiote_tpu_torch.ops import flash_attention as fa

    @contextlib.contextmanager
    def ctx():
        names = ("mh_flash_forward", "mh_flash_backward", "mh_flash_bwd_dkv",
                 "mh_flash_bwd_dq")
        saved = [getattr(fa, n) for n in names]
        for n in names:
            # the dispatchers' launch-counter name means nothing to a plain version
            setattr(fa, n, lambda *a, counter=None, _f=getattr(fa, n + "_plain"), **kw:
                    _f(*a, **kw))
        try:
            yield
        finally:
            for n, f in zip(names, saved):
                setattr(fa, n, f)
    return ctx()


def _attention_switch(**flags):
    """Context: module switches of the port's flash attention set for a
    measurement: FUSED_MULTIKV_BWD=False takes the split pair; skip=False
    makes every call walk every tile (no switch of the package does that:
    the dispatch always skips)."""
    import contextlib
    from omnibiote_tpu_torch.ops import flash_attention as fa

    @contextlib.contextmanager
    def ctx():
        saved = {}
        for name, value in flags.items():
            if name == "skip":
                if not value:
                    saved["_skip_and_bounds"] = fa._skip_and_bounds
                    fa._skip_and_bounds = lambda *a: (False, None)
            else:
                saved[name] = getattr(fa, name)
                setattr(fa, name, value)
        try:
            yield
        finally:
            for name, value in saved.items():
                setattr(fa, name, value)
    return ctx()


def _write_shards(root, n_tokens, seed):
    """Synthetic token shards of the 'mixed' mixture's train and val dirs:
    sequences of 50-3000 random ids, each ended by EOS."""
    import numpy as np
    from omnibiote_tpu_torch.config import EOS_TOKEN

    rng = np.random.default_rng(seed)
    for corpus in ("genbank/train", "uniref100/train", "genbank/val", "uniref100/val"):
        d = os.path.join(root, corpus)
        os.makedirs(d)
        toks = rng.integers(20, 65000, size=n_tokens).astype(np.int32)
        ends = np.cumsum(rng.integers(50, 3000, size=n_tokens // 50))
        toks[ends[ends < n_tokens]] = EOS_TOKEN
        np.save(os.path.join(d, "shard0.npy"), toks)


def train_slice_phase(workdir):
    """The training path at omnibiote-small width; returns the launches of
    its main-path run (the CLI)."""
    import copy
    import json as _json
    import torch
    from omnibiote_tpu_torch import num_params, preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.models.omnibiota import init_params
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.training import cli
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
    from omnibiote_tpu_torch.training.metrics import flops_per_token, mfu
    from omnibiote_tpu_torch.training.mlm import mlm_loss
    from omnibiote_tpu_torch.training.optim import make_optimizer
    from omnibiote_tpu_torch.training.train import (
        Trainer, _compute_copy, make_train_step)

    mini, accum, ctx = 16, 2, 1024
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT)
    check((cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.block_size, cfg.compute_dtype)
          == (8, 1024, 8, ctx, "bfloat16"), f"unexpected omnibiote-small config {cfg}")
    L = cfg.n_layer
    tc = TrainConfig(batch_size=mini * accum, mini_batch_size=mini, ctx_len=ctx,
                     token_budget=float(mini * accum * ctx * 10000), seed=0)
    batch = next(bench_batches(mini * accum, ctx, seed=1))
    tokens = torch.from_numpy(batch["tokens"]).cuda().view(accum, mini, ctx)
    segments = torch.from_numpy(batch["segments"]).cuda().view(accum, mini, ctx)

    # -- one micro-batch: mlm_loss and its backward, kernels vs plain ------
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(gen, cfg, device="cuda")

    def loss_and_grads():
        params_c = _compute_copy(dict(model.named_parameters()), cfg)
        loss, _ = mlm_loss(model, tokens[0], segments[0], 1234, params=params_c)
        grads = torch.autograd.grad(loss, list(params_c.values()))
        return loss.item(), dict(zip(params_c, grads))

    _kernels.reset_launches()
    loss_k, grads_k = loss_and_grads()
    launches = dict(_kernels.LAUNCHES)
    check(launches == _counts(mh_flash_fwd=L, mh_flash_bwd=L),
          f"one micro-batch launched {launches}, want {L} of each")
    with _plain_attention():
        loss_p, grads_p = loss_and_grads()
    check(_kernels.LAUNCHES == launches, "the plain run launched a kernel")
    worst_cos = min(torch.nn.functional.cosine_similarity(
        grads_k[n].double().flatten(), grads_p[n].double().flatten(), dim=0).item()
        for n in grads_k)
    print(f"train micro-batch (mini {mini}, T {ctx}, dropout {TRAIN_DROPOUT}): loss "
          f"kernels {loss_k:.6f} plain {loss_p:.6f} (|d| {abs(loss_k - loss_p):.2e}, "
          f"limit {TRAIN_LOSS_ATOL}); worst gradient cosine {worst_cos:.6f} over "
          f"{len(grads_k)} tensors (limit {TRAIN_GRAD_COS})")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL, "micro-batch loss: kernels vs plain")
    check(worst_cos >= TRAIN_GRAD_COS, "micro-batch gradients: kernels vs plain")
    del grads_k, grads_p

    # -- one train step with A = 2, kernels vs plain ----------------------
    twin = copy.deepcopy(model)

    def one_step(m):
        params = dict(m.named_parameters())
        opt = make_optimizer(list(params), cfg, tc, 10000)
        state = opt.init(params)
        step = make_train_step(m, cfg, tc, opt)
        return step(params, state, tokens, segments, [1.0] * accum, 99, 0)

    _kernels.reset_launches()
    met_k = one_step(model)
    gn_k = float(met_k["grad_norm"])
    launches = dict(_kernels.LAUNCHES)
    check(launches == _counts(mh_flash_fwd=L * accum, mh_flash_bwd=L * accum),
          f"one train step launched {launches}, want {L * accum} of each")
    with _plain_attention():
        met_p = one_step(twin)
    gn_p = float(met_p["grad_norm"])
    check(_kernels.LAUNCHES == launches, "the plain step launched a kernel")
    print(f"train step A={accum}: grad_norm kernels {gn_k:.6f} plain {gn_p:.6f} "
          f"(relative {abs(gn_k - gn_p) / gn_p:.2e}, limit {TRAIN_GNORM_RTOL}); loss "
          f"{float(met_k['loss']):.6f} vs {float(met_p['loss']):.6f}; launches {launches}")
    check(abs(gn_k - gn_p) <= TRAIN_GNORM_RTOL * gn_p, "train step grad_norm: kernels vs plain")
    del model, twin, met_k, met_p
    torch.cuda.empty_cache()

    # -- the CLI: the training main path -----------------------------------
    data = os.path.join(workdir, "data")
    _write_shards(data, 600_000, seed=2)
    log = os.path.join(workdir, "metrics.jsonl")
    steps = 4
    argv = ["--base_dir", data, "--train_type", "mixed", "--n_layer", str(L),
            "--n_embd", "1024", "--n_head", "8", "--ctx_len", str(ctx),
            "--dropout", str(TRAIN_DROPOUT), "--mini_batch_size", str(mini),
            "--batch_size", str(mini * accum), "--max_steps", str(steps),
            "--save_dir", os.path.join(workdir, "ckpt"), "--metrics_jsonl", log,
            "--log_every", "1", "--test_freq", "50000"]
    print("train CLI: python -m omnibiote_tpu_torch.training.cli " + " ".join(argv))
    # main path: every count at 0 just before, read just after
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    trainer = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    reloaded, _ = load_model_checkpoint(os.path.join(workdir, "ckpt", "omnibiota"))
    for n, p in reloaded.named_parameters():
        check(torch.equal(p, trainer.params[n]), f"checkpoint reload differs at {n}")
    del trainer, reloaded
    torch.cuda.empty_cache()
    # and one more step, resumed from that checkpoint
    resumed = cli.run(argv[:argv.index("--max_steps")] + ["--max_steps", "1"]
                       + argv[argv.index("--max_steps") + 2:] + ["--resume_from", "-1"])
    torch.cuda.synchronize()
    main_launches = dict(_kernels.LAUNCHES)
    with open(log) as f:
        recs = [_json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    probes = [k for r in recs for k in r if k.startswith("test_loss/")]
    want = _counts(mh_flash_fwd=(steps + 1) * L * accum + len(probes) * L,
                   mh_flash_bwd=(steps + 1) * L * accum)
    print(f"train CLI: {steps} steps in {wall:.2f} s, the final checkpoint "
          f"reloads equal to the trainer's parameters, 1 step resumed from it "
          f"(step {resumed.step}); losses {[round(x, 4) for x in losses]}, "
          f"{len(probes)} validation probes ({L} forward launches each), "
          f"launches {main_launches} (want {want})")
    check(resumed.step == steps + 1, f"resumed run ended at step {resumed.step}")
    check(len(losses) == steps + 1 and all(math.isfinite(x) for x in losses),
          f"CLI losses {losses}")
    check(main_launches == want, f"CLI launches {main_launches}, want {want}")
    del resumed
    torch.cuda.empty_cache()

    # -- throughput at bench.py's shape ------------------------------------
    torch.cuda.reset_peak_memory_stats()
    with Trainer(cfg, tc, batch_iter=bench_batches(mini * accum, ctx, seed=3),
                 prefetch=2) as tr:
        for _ in range(3):
            tr.train_step_once()
        torch.cuda.synchronize()
        n = 10
        t0 = time.time()
        for _ in range(n):
            m = tr.train_step_once()
        torch.cuda.synchronize()
        dt = time.time() - t0
        loss = float(m["loss"])
        fpt = flops_per_token(num_params(tr.model, non_embedding=True), L,
                              cfg.n_embd, ctx)
    tps = n * mini * accum * ctx / dt
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss), f"non-finite throughput-run loss {loss}")
    print(f"train throughput B={mini * accum} (mini {mini} x accum {accum}) T={ctx} "
          f"dropout {TRAIN_DROPOUT} bf16: {tps:.1f} tokens/s, {1e3 * dt / n:.3f} ms a "
          f"step, peak allocated {peak / 2**30:.2f} GiB, MFU {mfu(tps, fpt):.4f} vs the "
          f"H100 bf16 dense peak ({fpt / 1e9:.4f} GFLOP a token), loss {loss:.4f}")
    return main_launches


# ---------------------------------------------------------------------------
# 5. long-context kernels
# ---------------------------------------------------------------------------

# bench_longctx.py's shapes: (mini-batch, context), five EOS a row.
LONG_SHAPES = ((8, 2048), (4, 4096))
LONG_EOS = 5


def _long_segments(layout, B, T, seed):
    """Segment ids (B, T) int32 on the card: 'packed' as bench_longctx.py's
    rows, else as _segments."""
    import torch
    if layout == "packed":
        return torch.from_numpy(
            next(bench_batches(B, T, seed, LONG_EOS))["segments"]).cuda().contiguous()
    return _segments(layout, B, T, torch.Generator(device="cuda").manual_seed(seed))


def _walked(fn, n_tiles_want, what):
    """Run fn(tile_count) and hold the tiles the kernel walked against the
    count its bounds give."""
    import torch
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = fn(count)
    torch.cuda.synchronize()
    check(int(count.item()) == n_tiles_want,
          f"{what}: walked {int(count.item())} tiles, the bounds give {n_tiles_want}")
    return out


def longctx_kernel_phase():
    """The forward with bounds, the fused multi-kv backward with bounds and
    the split pair against their plain versions at T >= 2048, the identities
    that skipping must keep, and the timings at bench_longctx.py's shapes.
    Returns the rows of mh_flash_bwd_mk, mh_flash_bwd_dkv and
    mh_flash_bwd_dq for the kernels line, the forward's time at T = 2048
    and its max |do| against plain at those shapes."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops import flash_attention as fa

    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)
    cases = [(2, 2048, dt, lay, TRAIN_DROPOUT) for dt in ("bfloat16", "float32")
             for lay in ("packed", "padded", "dense")]
    cases += [(2, 2048, "bfloat16", "packed", 0.0), (2, 2048, "float32", "packed", 0.0),
              (1, 4096, "bfloat16", "packed", TRAIN_DROPOUT)]
    for i, (B, T, dtype, layout, rate) in enumerate(cases):
        tdt = getattr(torch, dtype)
        tag = f"B={B} T={T} {dtype:8s} {layout:6s} dropout {rate}"
        q, k, v, _, rope = _attn_inputs(B, T, H, D, tdt, "dense", seed=300 + i)
        seg = _long_segments(layout, B, T, 300 + i)
        gen = torch.Generator(device="cuda").manual_seed(400 + i)
        do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(tdt)
        kw = dict(scale=scale, dropout_rate=rate, seed=0xD1B54A32D192ED03 + i)
        tq, tkv = fa.KERNEL_TILES["fwd"][tdt]
        dq_q, dq_kv = fa.KERNEL_TILES["dq"][tdt]
        bq, bkv = fa.KERNEL_TILES["fused"][tdt]
        kq, kkv = fa.KERNEL_TILES["dkv"][tdt]
        sb = None if seg is None else fa.SegmentBounds(seg)
        kv_b = None if sb is None else sb.get(tq, tkv)          # per forward q tile
        dq_b = None if sb is None else sb.get(dq_q, dq_kv)      # per dq q tile
        q_b = None if sb is None else sb.get(bkv, bq)           # per fused kv tile
        dkv_b = None if sb is None else sb.get(kkv, kq)         # per dkv kv tile
        n_kv = H * (B * (T // tq) * (T // tkv) if sb is None
                    else int((kv_b[1] - kv_b[0] + 1).sum()))
        n_dq = H * (B * (T // dq_q) * (T // dq_kv) if sb is None
                    else int((dq_b[1] - dq_b[0] + 1).sum()))
        n_q = H * (B * (T // bkv) * (T // bq) if sb is None
                   else int((q_b[1] - q_b[0] + 1).sum()))
        n_dkv = H * (B * (T // kkv) * (T // kq) if sb is None
                     else int((dkv_b[1] - dkv_b[0] + 1).sum()))

        # forward: bounds against the full walk (bit for bit), against plain
        o, lse = _walked(lambda c: fa.mh_flash_forward_kernel(
            q, k, v, seg, rope, kv_bounds=kv_b, tile_count=c, **kw), n_kv,
            f"forward {tag}")
        o_all, lse_all = fa.mh_flash_forward_kernel(q, k, v, seg, rope, **kw)
        check(torch.equal(o, o_all) and torch.equal(lse, lse_all),
              f"forward with bounds differs from the full walk at {tag}")
        po, plse = fa.mh_flash_forward_plain(
            q, k, v, seg, rope, block_kv=tkv, block_q=tq, segment_skip=True,
            bounds=sb, **kw)
        rt, at = TOL[dtype]["o"]
        rl, al = TOL[dtype]["lse"]
        err_o = (o.float() - po.float()).abs().max().item()
        check(torch.allclose(o.float(), po.float(), rtol=rt, atol=at)
              and torch.allclose(lse, plse, rtol=rl, atol=al),
              f"forward with bounds disagrees with its plain version at {tag}")

        di = (po.float() * do.float()).sum(-1)
        args = (q, k, v, do, plse, di, seg, rope)
        want = fa.mh_flash_backward_plain(*args, block_q=bq, block_kv=bkv,
                                          segment_skip=True, bounds=sb, **kw)
        # fused multi-kv: bounds against the full walk (dk, dv bit for bit,
        # dq within the atomics' tolerance), against plain
        mk = _walked(lambda c: fa.mh_flash_backward_kernel(
            *args, tile_bounds=q_b, tile_count=c, **kw), n_q,
            f"fused backward {tag}")
        mk_all = fa.mh_flash_backward_kernel(*args, **kw)
        check(torch.equal(mk[1], mk_all[1]) and torch.equal(mk[2], mk_all[2]),
              f"fused backward with bounds: dk or dv differs from the full walk at {tag}")
        check(_rel_err(mk[0], mk_all[0]) <= BWD_TOL[dtype],
              f"fused backward with bounds: dq differs from the full walk at {tag}")
        # split pair: each against the full walk and a second launch, bit for bit
        dkv = _walked(lambda c: fa.mh_flash_bwd_dkv_kernel(
            *args, tile_bounds=dkv_b, tile_count=c, **kw), n_dkv, f"dkv {tag}")
        dkv_all = fa.mh_flash_bwd_dkv_kernel(*args, **kw)
        check(torch.equal(dkv[0], dkv_all[0]) and torch.equal(dkv[1], dkv_all[1]),
              f"dkv kernel with bounds differs from the full walk at {tag}")
        dkv_again = fa.mh_flash_bwd_dkv_kernel(*args, tile_bounds=dkv_b, **kw)
        check(torch.equal(dkv[0], dkv_again[0]) and torch.equal(dkv[1], dkv_again[1]),
              f"dkv kernel: two launches give different bits at {tag}")
        dq = _walked(lambda c: fa.mh_flash_bwd_dq_kernel(
            *args, tile_bounds=dq_b, tile_count=c, **kw), n_dq, f"dq {tag}")
        check(torch.equal(dq, fa.mh_flash_bwd_dq_kernel(*args, **kw)),
              f"dq kernel with bounds differs from the full walk at {tag}")
        check(torch.equal(dq, fa.mh_flash_bwd_dq_kernel(*args, tile_bounds=dq_b, **kw)),
              f"dq kernel: two launches give different bits at {tag}")
        torch.cuda.synchronize()
        check(all(torch.isfinite(g.float()).all() for g in (*mk, *dkv, dq)),
              f"non-finite backward output at {tag}")
        e_mk = [_rel_err(g, w) for g, w in zip(mk, want)]
        e_sp = [_rel_err(g, w) for g, w in zip((dq, *dkv), want)]
        e_fs = [_rel_err(g, w) for g, w in zip(mk, (dq, *dkv))]
        print(f"long kernels {tag}: tiles walked fwd {n_kv} of "
              f"{H * B * (T // tq) * (T // tkv)}, dq {n_dq} of "
              f"{H * B * (T // dq_q) * (T // dq_kv)}, fused {n_q} of "
              f"{H * B * (T // bkv) * (T // bq)}, dkv {n_dkv} of "
              f"{H * B * (T // kkv) * (T // kq)}; fwd max|do| {err_o:.3e} (rtol {rt}, "
              f"atol {at}); max|d|/max|g| vs plain (dq, dk, dv): fused "
              f"{e_mk[0]:.2e} {e_mk[1]:.2e} {e_mk[2]:.2e}, split {e_sp[0]:.2e} "
              f"{e_sp[1]:.2e} {e_sp[2]:.2e}; fused vs split {max(e_fs):.2e} "
              f"(tolerance {BWD_TOL[dtype]}); bounds on == off; dk, dv and dq the "
              f"same bits at a second launch")
        check(max(e_mk) <= BWD_TOL[dtype], f"fused multi-kv backward disagrees at {tag}")
        check(max(e_sp) <= BWD_TOL[dtype], f"split backward disagrees at {tag}")
        check(max(e_fs) <= BWD_TOL[dtype], f"fused and split backward disagree at {tag}")
        del q, k, v, do, o, lse, po, plse, want, mk, mk_all, dkv, dkv_all, dkv_again, dq

    # the lse-exposing variant with a non-zero lse cotangent, through
    # autograd: kernels (fused, then split) against the plain versions
    B, T = 2, 2048
    qkv = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", seed=500)
    rope = qkv[4]
    seg = _long_segments("packed", B, T, 500)
    gen = torch.Generator(device="cuda").manual_seed(501)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
    dlse = torch.randn(B, T, H, generator=gen, device="cuda")

    def lse_grads():
        q, k, v = (x.clone().requires_grad_() for x in qkv[:3])
        o, lse = fa.flash_attention_lse(q, k, v, seg, rope, scale=scale,
                                        dropout_rate=TRAIN_DROPOUT, seed=77,
                                        block_q=512, block_kv=512)
        return (lse, *torch.autograd.grad((o, lse), (q, k, v), (do, dlse)))

    with _plain_attention():
        want = lse_grads()
    for fused in (True, False):
        with _attention_switch(FUSED_MULTIKV_BWD=fused):
            got = lse_grads()
        errs = [_rel_err(g, w) for g, w in zip(got[1:], want[1:])]
        print(f"flash_attention_lse with a random dlse, {'fused' if fused else 'split'} "
              f"backward vs plain: max|dlse| {(got[0] - want[0]).abs().max().item():.2e}, "
              f"max|d|/max|g| {max(errs):.2e} (tolerance {BWD_TOL['bfloat16']})")
        check(torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-4)
              and max(errs) <= BWD_TOL["bfloat16"],
              "flash_attention_lse: kernels disagree with the plain versions")
    del qkv, do, dlse, want, got

    # timings at bench_longctx.py's shapes: bf16, RoPE, dropout 0.1, five EOS
    # a row; each kernel with skipping (the main path) and without
    rows, fwd_ms_2048 = [], None
    worst = {"fwd": 0.0, "mk": 0.0, "dkv": 0.0, "dq": 0.0}
    for B, T in LONG_SHAPES:
        q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 600 + T)
        seg = _long_segments("packed", B, T, 600 + T)
        gen = torch.Generator(device="cuda").manual_seed(700 + T)
        do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
        sb = fa.SegmentBounds(seg)
        kw = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=4242)
        o, lse = fa.mh_flash_forward(q, k, v, seg, rope, segment_skip=True, bounds=sb, **kw)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, do, lse, di, seg, rope)
        kernels = {
            "mh_flash_fwd": lambda **s: fa.mh_flash_forward(q, k, v, seg, rope, **kw, **s),
            "mh_flash_bwd_mk": lambda **s: fa.mh_flash_backward(*args, **kw, **s),
            "mh_flash_bwd_dkv": lambda **s: fa.mh_flash_bwd_dkv(*args, **kw, **s),
            "mh_flash_bwd_dq": lambda **s: fa.mh_flash_bwd_dq(*args, **kw, **s),
        }
        ms = {n: (cuda_ms(lambda: f(segment_skip=True, bounds=sb), 10),
                  cuda_ms(lambda: f(), 10)) for n, f in kernels.items()}
        # every kernel against its plain version at this shape, called as
        # the main path calls it (skipping on)
        shape = f"the long shape B={B} T={T}"
        got = {n: f(segment_skip=True, bounds=sb) for n, f in kernels.items()}
        fq, fkv = fa.KERNEL_TILES["fwd"][torch.bfloat16]
        err_f = _hold_fwd(got["mh_flash_fwd"], fa.mh_flash_forward_plain(
            q, k, v, seg, rope, block_q=fq, block_kv=fkv, segment_skip=True,
            bounds=sb, **kw), "bfloat16", shape)
        bq, bkv = fa.KERNEL_TILES["fused"][torch.bfloat16]
        kq, kkv = fa.KERNEL_TILES["dkv"][torch.bfloat16]
        dq_q, dq_kv = fa.KERNEL_TILES["dq"][torch.bfloat16]
        want = fa.mh_flash_backward_plain(*args, block_q=bq, block_kv=bkv,
                                          segment_skip=True, bounds=sb, **kw)
        held = {"mk": _hold_bwd(got["mh_flash_bwd_mk"], want, "bfloat16", f"{shape} (fused)"),
                "dkv": _hold_bwd(got["mh_flash_bwd_dkv"], want[1:], "bfloat16", f"{shape} (dkv)"),
                "dq": _hold_bwd((got["mh_flash_bwd_dq"],), want[:1], "bfloat16", f"{shape} (dq)")}
        print(f"kernels vs plain at {shape} bf16 dropout {TRAIN_DROPOUT}: fwd max|do| "
              f"{err_f:.3e} (rtol, atol {TOL['bfloat16']['o']}); max|d|/max|g| fused "
              f"{held['mk'][0]:.2e}, dkv {held['dkv'][0]:.2e}, dq {held['dq'][0]:.2e} "
              f"(tolerance {BWD_TOL['bfloat16']})")
        for key, err in (("fwd", err_f), *((n, e[1]) for n, e in held.items())):
            worst[key] = max(worst[key], err)
        del got, want
        torch.cuda.empty_cache()
        pairs = _visible_pairs(seg, B, T)
        bounds = {"mh_flash_fwd": (_attn_bound(B, T, H, D, pairs), _attn_bound(B, T, H, D)),
                  **{f"mh_flash_bwd_{n}": (_bwd_bound(B, T, H, D, pairs, kind),
                                           _bwd_bound(B, T, H, D, None, kind))
                     for n, kind in (("mk", "fused"), ("dkv", "dkv"), ("dq", "dq"))}}
        kvb, qb, kb, db = sb.get(fq, fkv), sb.get(bkv, bq), sb.get(kkv, kq), sb.get(dq_q, dq_kv)
        print(f"long shape B={B} T={T} H={H} D={D} bf16, {LONG_EOS} EOS a row, dropout "
              f"{TRAIN_DROPOUT}: visible share of (q, k) pairs {pairs / (B * T * T):.4f}, "
              f"walked share of the forward's {fq}x{fkv} tiles "
              f"{int((kvb[1] - kvb[0] + 1).sum()) / (B * (T // fq) * (T // fkv)):.4f}, "
              f"of the fused backward's {bkv}x{bq} tiles "
              f"{int((qb[1] - qb[0] + 1).sum()) / (B * (T // bkv) * (T // bq)):.4f}, "
              f"of the dkv kernel's {kkv}x{kq} tiles "
              f"{int((kb[1] - kb[0] + 1).sum()) / (B * (T // kkv) * (T // kq)):.4f}, "
              f"of the dq kernel's {dq_q}x{dq_kv} tiles "
              f"{int((db[1] - db[0] + 1).sum()) / (B * (T // dq_q) * (T // dq_kv)):.4f}")
        for n in kernels:
            (b_vis, by), (b_all, _) = bounds[n]
            print(f"  {n}: {ms[n][0]:.4f} ms with skipping, {ms[n][1]:.4f} ms without; "
                  f"bound {b_vis:.4f} ms over visible pairs, {b_all:.4f} over all ({by})")
        print(f"  split pair {ms['mh_flash_bwd_dkv'][0] + ms['mh_flash_bwd_dq'][0]:.4f} ms "
              f"against fused {ms['mh_flash_bwd_mk'][0]:.4f} ms with skipping; "
              f"{ms['mh_flash_bwd_dkv'][1] + ms['mh_flash_bwd_dq'][1]:.4f} against "
              f"{ms['mh_flash_bwd_mk'][1]:.4f} without")
        if T != 2048:
            continue
        fwd_ms_2048 = ms["mh_flash_fwd"][0]
        # the split pair without dropout (skipping on): what its two Philox
        # draws, one in each kernel, cost
        kw0 = dict(kw, dropout_rate=0.0)
        nodrop = {"mh_flash_bwd_dkv": cuda_ms(lambda: fa.mh_flash_bwd_dkv(
                      *args, **kw0, segment_skip=True, bounds=sb), 10),
                  "mh_flash_bwd_dq": cuda_ms(lambda: fa.mh_flash_bwd_dq(
                      *args, **kw0, segment_skip=True, bounds=sb), 10)}
        print("  without dropout, skipping: " + ", ".join(
            f"{n} {t:.4f} ms (dropout {TRAIN_DROPOUT}: {ms[n][0]:.4f}, the draw's share "
            f"{1 - t / ms[n][0]:.3f})" for n, t in nodrop.items()))
        # plain versions (with the same skipping) and the library yardstick:
        # SDPA with dropout, dense (it takes no segment ids); its backward
        # as (forward + backward) - forward through autograd
        plain_ms = {
            "mh_flash_bwd_mk": cuda_ms(lambda: fa.mh_flash_backward_plain(
                *args, block_q=bq, block_kv=bkv, segment_skip=True, bounds=sb, **kw), 2, warmup=1),
            "mh_flash_bwd_dkv": cuda_ms(lambda: fa.mh_flash_bwd_dkv_plain(
                *args, block_q=kq, block_kv=kkv, segment_skip=True, bounds=sb, **kw), 2, warmup=1),
            "mh_flash_bwd_dq": cuda_ms(lambda: fa.mh_flash_bwd_dq_plain(
                *args, block_q=dq_q, block_kv=dq_kv, segment_skip=True, bounds=sb, **kw), 2,
                warmup=1),
        }
        qr, kr = apply_rope_half(q, k, *rope)
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (qr, kr, v))
        doh = do.transpose(1, 2).contiguous()
        sdpa = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=TRAIN_DROPOUT, scale=scale)
        with torch.no_grad():
            lib_fwd = cuda_ms(sdpa, 10)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh), 10) - lib_fwd
        print(f"  plain: fused {plain_ms['mh_flash_bwd_mk']:.3f} ms, dkv "
              f"{plain_ms['mh_flash_bwd_dkv']:.3f} ms, dq {plain_ms['mh_flash_bwd_dq']:.3f} ms; "
              f"SDPA dense with dropout: forward {lib_fwd:.4f} ms, backward {lib_bwd:.4f} ms")
        for name, src, line, key, lib in (
                ("mh_flash_bwd_mk", "mh_flash_bwd.cu", 1128, "mk", lib_bwd),
                ("mh_flash_bwd_dkv", "mh_flash_bwd_dkv.cu", 773, "dkv", None),
                ("mh_flash_bwd_dq", "mh_flash_bwd_dq.cu", 866, "dq", None)):
            rows.append({"name": name, "route": "cuda",
                         "source": f"omnibiote_tpu_torch/ops/csrc/{src}",
                         "replaces": f"omnibiote_tpu/ops/flash_attention.py:{line}",
                         "launches": None, "max_abs_err": key,
                         "ms": ms[name][0], "plain_ms": plain_ms[name],
                         "bound_ms": bounds[name][0][0], "bound_by": bounds[name][0][1],
                         "library_ms": lib})
        del qh, kh, vh, qr, kr, doh
    for row in rows:   # the worst over both long shapes
        row["max_abs_err"] = worst[row["max_abs_err"]]
    return rows, fwd_ms_2048, worst["fwd"]


# ---------------------------------------------------------------------------
# 6. long-context training slice
# ---------------------------------------------------------------------------

# Peak allocated memory of a training run above what was allocated before
# it, by run (_peak_key): (bytes, the base, the run that measured it). Only
# the runs of the pod planner's anchors record here (phase 13's lever runs,
# phase 17's pp Trainer at checkpoint_freq 0), each once; phase 18 reads
# these rather than running them again.
MEASURED_PEAKS = {}


def _peak_key(cfg, tc):
    """What sets a Trainer run's peak memory: the model, its levers and the
    step's shape, sharding and optimizer dtypes."""
    return (cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.vocab_size, cfg.dropout,
            cfg.checkpoint_freq, cfg.checkpoint_freq and cfg.remat_policy, cfg.fused_ce,
            cfg.attn_impl, tc.ctx_len, tc.mini_batch_size, tc.batch_size, tc.sharding,
            tuple(tc.mesh_shape or ()), tc.moment_dtype, tc.grad_dtype)


def _record_peak(cfg, tc, peak, base, source):
    """Keep an anchor run's peak above its base; a second run of the same
    key is refused, so no later run replaces an anchor's peak."""
    key = _peak_key(cfg, tc)
    check(key not in MEASURED_PEAKS, f"a second peak for {key}: {source} after "
          f"{MEASURED_PEAKS.get(key, (0, 0, ''))[2]}")
    MEASURED_PEAKS[key] = (peak, base, source)


def _counts(**nonzero):
    from omnibiote_tpu_torch.ops import _kernels
    return {**dict.fromkeys(_kernels.LAUNCHES, 0), **nonzero}


def _throughput(cfg, tc, n_eos, steps, label, record=False):
    """Tokens/s of Trainer.train_step_once over `steps` steps after three
    warm-up steps, with peak allocated memory and MFU. record: keep the
    run's peak as a pod-planner anchor's (phase 18)."""
    import torch
    from omnibiote_tpu_torch import num_params
    from omnibiote_tpu_torch.training.metrics import flops_per_token, mfu
    from omnibiote_tpu_torch.training.train import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with Trainer(cfg, tc, batch_iter=bench_batches(tc.batch_size, tc.ctx_len, 3, n_eos),
                 prefetch=2) as tr:
        for _ in range(3):
            tr.train_step_once()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(steps):
            m = tr.train_step_once()
        torch.cuda.synchronize()
        dt = time.time() - t0
        loss = float(m["loss"])
        fpt = flops_per_token(num_params(tr.model, non_embedding=True), cfg.n_layer,
                              cfg.n_embd, tc.ctx_len)
    tps = steps * tc.batch_size * tc.ctx_len / dt
    if record:
        _record_peak(cfg, tc, torch.cuda.max_memory_allocated() - base, base,
                     f"throughput run {label}")
    check(math.isfinite(loss), f"non-finite throughput-run loss {loss} ({label})")
    print(f"train throughput {label}: B={tc.batch_size} (mini {tc.mini_batch_size}) "
          f"T={tc.ctx_len} {n_eos} EOS a row, dropout {cfg.dropout} bf16: {tps:.1f} "
          f"tokens/s, {1e3 * dt / steps:.3f} ms a step, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, MFU {mfu(tps, fpt):.4f} "
          f"vs the H100 bf16 dense peak ({fpt / 1e9:.4f} GFLOP a token), loss {loss:.4f}")
    return tps


def longctx_slice_phase(workdir):
    """Packed MLM pretraining at block_size = ctx_len = 2048 (and 4096 for
    throughput); returns (launches of the CLI run, launches of the split
    run)."""
    import copy
    import json as _json
    import torch
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.models.omnibiota import init_params
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.training import cli
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
    from omnibiote_tpu_torch.training.mlm import mlm_loss
    from omnibiote_tpu_torch.training.optim import make_optimizer
    from omnibiote_tpu_torch.training.train import (
        Trainer, _compute_copy, make_train_step)

    mini, accum, ctx = 8, 2, 2048
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                 block_size=ctx)
    check((cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.block_size, cfg.compute_dtype)
          == (8, 1024, 8, ctx, "bfloat16"), f"unexpected long-context config {cfg}")
    L = cfg.n_layer
    tc = TrainConfig(batch_size=mini * accum, mini_batch_size=mini, ctx_len=ctx,
                     token_budget=float(mini * accum * ctx * 10000), seed=0)
    batch = next(bench_batches(mini * accum, ctx, 1, LONG_EOS))
    tokens = torch.from_numpy(batch["tokens"]).cuda().view(accum, mini, ctx)
    segments = torch.from_numpy(batch["segments"]).cuda().view(accum, mini, ctx)
    fused_counts = lambda n: _counts(mh_flash_fwd=n, mh_flash_bwd_mk=n)
    split_counts = lambda n: _counts(mh_flash_fwd=n, mh_flash_bwd_dkv=n, mh_flash_bwd_dq=n)

    # -- one micro-batch: fused, split, plain -----------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = init_params(gen, cfg, device="cuda")

    def loss_and_grads():
        params_c = _compute_copy(dict(model.named_parameters()), cfg)
        loss, _ = mlm_loss(model, tokens[0], segments[0], 1234, params=params_c)
        grads = torch.autograd.grad(loss, list(params_c.values()))
        return loss.item(), dict(zip(params_c, grads))

    with _plain_attention():
        _kernels.reset_launches()
        loss_p, grads_p = loss_and_grads()
        check(_kernels.LAUNCHES == _counts(), "the plain run launched a kernel")
    for fused in (True, False):
        name = "fused backward" if fused else "split pair"
        with _attention_switch(FUSED_MULTIKV_BWD=fused):
            _kernels.reset_launches()
            loss_k, grads_k = loss_and_grads()
        want = fused_counts(L) if fused else split_counts(L)
        check(_kernels.LAUNCHES == want,
              f"one micro-batch ({name}) launched {_kernels.LAUNCHES}, want {want}")
        worst_cos = min(torch.nn.functional.cosine_similarity(
            grads_k[n].double().flatten(), grads_p[n].double().flatten(), dim=0).item()
            for n in grads_k)
        print(f"long micro-batch (mini {mini}, T {ctx}, dropout {TRAIN_DROPOUT}, {name}): "
              f"loss kernels {loss_k:.6f} plain {loss_p:.6f} (|d| {abs(loss_k - loss_p):.2e}, "
              f"limit {TRAIN_LOSS_ATOL}); worst gradient cosine {worst_cos:.6f} over "
              f"{len(grads_k)} tensors (limit {TRAIN_GRAD_COS})")
        check(abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL, f"long micro-batch loss ({name})")
        check(worst_cos >= TRAIN_GRAD_COS, f"long micro-batch gradients ({name})")
        del grads_k
    del grads_p

    # -- one train step with A = 2: fused, split, plain -------------------
    def one_step(m):
        params = dict(m.named_parameters())
        opt = make_optimizer(list(params), cfg, tc, 10000)
        state = opt.init(params)
        step = make_train_step(m, cfg, tc, opt)
        return step(params, state, tokens, segments, [1.0] * accum, 99, 0)

    with _plain_attention():
        met_p = one_step(copy.deepcopy(model))
    gn_p = float(met_p["grad_norm"])
    for fused in (True, False):
        name = "fused backward" if fused else "split pair"
        with _attention_switch(FUSED_MULTIKV_BWD=fused):
            _kernels.reset_launches()
            met_k = one_step(copy.deepcopy(model))
        gn_k = float(met_k["grad_norm"])
        want = fused_counts(L * accum) if fused else split_counts(L * accum)
        check(_kernels.LAUNCHES == want,
              f"one long train step ({name}) launched {_kernels.LAUNCHES}, want {want}")
        print(f"long train step A={accum} ({name}): grad_norm kernels {gn_k:.6f} plain "
              f"{gn_p:.6f} (relative {abs(gn_k - gn_p) / gn_p:.2e}, limit "
              f"{TRAIN_GNORM_RTOL}); loss {float(met_k['loss']):.6f} vs "
              f"{float(met_p['loss']):.6f}; launches a step {dict(_kernels.LAUNCHES)}")
        check(abs(gn_k - gn_p) <= TRAIN_GNORM_RTOL * gn_p,
              f"long train step grad_norm ({name})")
    del model, met_k, met_p
    torch.cuda.empty_cache()

    # -- the CLI at --ctx_len 2048: this slice's main path -----------------
    data = os.path.join(workdir, "data_long")
    _write_shards(data, 600_000, seed=4)
    log = os.path.join(workdir, "metrics_long.jsonl")
    steps = 3
    argv = ["--base_dir", data, "--train_type", "mixed", "--n_layer", str(L),
            "--n_embd", "1024", "--n_head", "8", "--ctx_len", str(ctx),
            "--dropout", str(TRAIN_DROPOUT), "--mini_batch_size", str(mini),
            "--batch_size", str(mini * accum), "--max_steps", str(steps),
            "--save_dir", os.path.join(workdir, "ckpt_long"), "--metrics_jsonl", log,
            "--log_every", "1", "--test_freq", "50000"]
    print("train CLI: python -m omnibiote_tpu_torch.training.cli " + " ".join(argv))
    # main path: every count at 0 just before, read just after
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    trainer = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(trainer.model.cfg.block_size == ctx and trainer.model.rope_cos.shape[0] == ctx,
          "the CLI's model was not built at the long context")
    reloaded, _ = load_model_checkpoint(os.path.join(workdir, "ckpt_long", "omnibiota"))
    for n, p in reloaded.named_parameters():
        check(torch.equal(p, trainer.params[n]), f"checkpoint reload differs at {n}")
    del trainer, reloaded
    torch.cuda.empty_cache()
    resumed = cli.run(argv[:argv.index("--max_steps")] + ["--max_steps", "1"]
                       + argv[argv.index("--max_steps") + 2:] + ["--resume_from", "-1"])
    torch.cuda.synchronize()
    cli_launches = dict(_kernels.LAUNCHES)
    with open(log) as f:
        recs = [_json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    probes = [k for r in recs for k in r if k.startswith("test_loss/")]
    want = _counts(mh_flash_fwd=(steps + 1) * L * accum + len(probes) * L,
                   mh_flash_bwd_mk=(steps + 1) * L * accum)
    print(f"train CLI at ctx {ctx}: {steps} steps in {wall:.2f} s, the final checkpoint "
          f"reloads equal, 1 step resumed from it (step {resumed.step}); losses "
          f"{[round(x, 4) for x in losses]}, {len(probes)} validation probes, launches "
          f"{cli_launches} (want {want})")
    check(resumed.step == steps + 1, f"resumed long run ended at step {resumed.step}")
    check(len(losses) == steps + 1 and all(math.isfinite(x) for x in losses),
          f"long CLI losses {losses}")
    check(cli_launches == want, f"long CLI launches {cli_launches}, want {want}")
    del resumed
    torch.cuda.empty_cache()

    # -- the split pair's main path: Trainer.run with the switch off --------
    n_split = 2
    with _attention_switch(FUSED_MULTIKV_BWD=False):
        with Trainer(cfg, tc, batch_iter=bench_batches(mini * accum, ctx, 5, LONG_EOS)) as tr:
            _kernels.reset_launches()
            tr.run(max_steps=n_split)
            torch.cuda.synchronize()
            split_launches = dict(_kernels.LAUNCHES)
    del tr
    want = split_counts(n_split * L * accum)
    print(f"Trainer.run with FUSED_MULTIKV_BWD = False: {n_split} steps, launches "
          f"{split_launches} (want {want})")
    check(split_launches == want, f"split run launches {split_launches}, want {want}")

    # -- throughput ---------------------------------------------------------
    # (tools/gpu_profile_train.py takes --no_skip and --split for the other
    # combinations at either context)
    tag = f"ctx {ctx}"
    _throughput(cfg, tc, LONG_EOS, 8, f"{tag}, skipping, fused backward")
    with _attention_switch(skip=False):
        _throughput(cfg, tc, LONG_EOS, 8, f"{tag}, every tile, fused backward")
    with _attention_switch(FUSED_MULTIKV_BWD=False):
        _throughput(cfg, tc, LONG_EOS, 8, f"{tag}, skipping, split pair")
    mini4, ctx4 = LONG_SHAPES[1]
    cfg4 = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                  block_size=ctx4)
    tc4 = TrainConfig(batch_size=mini4 * accum, mini_batch_size=mini4, ctx_len=ctx4,
                      token_budget=float(mini4 * accum * ctx4 * 10000), seed=0)
    _kernels.reset_launches()
    _throughput(cfg4, tc4, LONG_EOS, 6, f"ctx {ctx4}, skipping, fused backward")
    check(_kernels.LAUNCHES == _counts(mh_flash_fwd=9 * L * accum, mh_flash_bwd_mk=9 * L * accum),
          f"ctx {ctx4} run launched {_kernels.LAUNCHES}")
    return cli_launches, split_launches


# ---------------------------------------------------------------------------
# 7. int8 attention kernel
# ---------------------------------------------------------------------------

# The int8 kernel vs its plain version. Both take the same integers (the
# prologue's are compared bit for bit), the same fp32 scores and the same
# row maxima, so they differ in the order of l's fp32 sum and, wherever
# exp2f and torch.exp2 differ in the last bit at a rounding boundary, in one
# step of a p8 (1/127 of one key's weight, against a row's l of tens). fp32
# outputs are held to 1e-4 absolute and relative; bf16 outputs, where such a
# difference can flip the rounding of o by one bf16 ulp (2^-8 relative), to
# the bf16 forward kernel's 8e-3.
INT8_TOL = {"bfloat16": (8e-3, 8e-3), "float32": (1e-4, 1e-4)}


def _int8_bound(B, T, H, D, itemsize, pairs=None, rope=True):
    """(bound_ms, bound_by) of one int8 attention call: two products over
    `pairs` (q, k) pairs (default all) at the int8 dense peak, against q, k,
    v read and o written once in the input dtype, plus the rope tables."""
    pairs = float(B) * T * T if pairs is None else pairs
    nbytes = 4 * B * T * H * D * itemsize + (2 * T * (D // 2) * 4 if rope else 0)
    return _bound(4.0 * pairs * H * D, nbytes, PEAK_INT8_OPS)


def _hold_int8(q, k, v, seg, rope, scale, tag):
    """Prologue and output of the int8 kernel against the plain version on
    the same inputs; returns (max |do|, the kernel's o)."""
    import torch
    from omnibiote_tpu_torch.ops import int8_attention as i8

    dtype = str(q.dtype).split(".")[1]
    got = i8.int8_quantize_kernel(q, k, v, rope)
    torch.cuda.synchronize()
    want = i8.int8_kernel_layout(*i8.int8_quantize_plain(q, k, v, rope))
    for name, g, w in zip(("q8", "sq", "k8", "sk", "v8t", "sv"), got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"int8 prologue {name}: {tuple(g.shape)} {g.dtype} at {tag}")
        check(torch.equal(g, w), f"int8 prologue {name} differs from the plain "
              f"version's at {tag}: {(g != w).float().mean().item():.2e} of its elements")
    # block_q as the dispatch's _fit_block would give it for any T here
    o = i8.int8_flash_attention(q, k, v, scale=scale, segment_ids=seg, block_q=128,
                                rope=rope)
    torch.cuda.synchronize()
    po = i8.int8_flash_attention_plain(q, k, v, scale=scale, segment_ids=seg,
                                       block_q=128, rope=rope)
    check(o.shape == q.shape and o.dtype == q.dtype and
          bool(torch.isfinite(o.float()).all()), f"int8 kernel output at {tag}")
    rt, at = INT8_TOL[dtype]
    err = _abs_err(o, po)
    check(torch.allclose(o.float(), po.float(), rtol=rt, atol=at),
          f"int8 kernel disagrees with its plain version at {tag}: max|do| {err:.3e}")
    # the attention kernel alone on the prologue's tensors: the same bits
    oa = i8.int8_attention_from_quantized(got, scale=scale, dtype=q.dtype, segment_ids=seg)
    check(torch.equal(oa, o), f"the int8 attention kernel alone differs from the call at {tag}")
    return err, o


def _hold_int8_products(quantized, tag):
    """int8_products (the attention kernel's products alone) against its
    plain version on a prologue's integers: int32 sums, equal bit for bit."""
    import torch
    from omnibiote_tpu_torch.probes import roofline as r1

    q8, _, k8, _, v8t, _ = quantized
    got = r1.int8_products(q8, k8, v8t)
    torch.cuda.synchronize()
    want = r1.int8_products_plain(q8, k8, v8t)
    check(got.dtype == torch.int32 and torch.equal(got, want),
          f"int8_products differs from its plain version at {tag}: "
          f"{(got != want).float().mean().item():.2e} of its elements")


def int8_kernel_phase():
    """The int8 attention kernel and its products alone against their plain
    versions; returns its row of the kernels line (launches filled in by the
    serving slice)."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops import int8_attention as i8
    from omnibiote_tpu_torch.ops.flash_attention import mh_flash_forward
    from omnibiote_tpu_torch.probes import roofline as r1

    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)
    worst = {"bfloat16": 0.0, "float32": 0.0}
    n = 0
    for T in (128, 640, 1024, 2048):
        for dtype in ("bfloat16", "float32"):
            for layout in ("packed", "padded", "dense"):
                for use_rope in (True, False):
                    q, k, v, seg, rope = _attn_inputs(
                        2, T, H, D, getattr(torch, dtype), layout, seed=800 + n)
                    err, _ = _hold_int8(q, k, v, seg, rope if use_rope else None, scale,
                                        (2, T, dtype, layout, use_rope))
                    worst[dtype] = max(worst[dtype], err)
                    n += 1
        _hold_int8_products(i8.int8_quantize_kernel(q, k, v, rope), (2, T))
    print(f"int8 kernel vs plain: {n} cases (B=2, T 128/640/1024/2048, bf16 and fp32, "
          f"packed/padded/dense, RoPE and none): q8, k8, v8t (kernel layout) and their "
          f"scales equal bit for bit; the attention kernel alone equals the call; max|do| "
          f"bf16 {worst['bfloat16']:.3e} (rtol, atol {INT8_TOL['bfloat16']}), fp32 "
          f"{worst['float32']:.3e} ({INT8_TOL['float32']}); int8_products equal to its "
          f"plain version at T 128/640/1024/2048")

    # the serving shape: dense (encode) and padded (the masked Encoder)
    B, T = 32, 1024
    q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 99)
    _, _, _, pseg, _ = _attn_inputs(B, T, H, D, torch.bfloat16, "padded", 98)
    err_d, o8 = _hold_int8(q, k, v, None, rope, scale, "the serving shape, dense")
    err_p, o8p = _hold_int8(q, k, v, pseg, rope, scale, "the serving shape, padded")
    # against the bf16 kernel: the cosine of each batch row's output (real
    # tokens) is held to MIN_COSINE; the least cosine of one (token, head)
    # vector, printed beside it, is the int8 function's own precision on
    # near-uniform attention over random values (the plain version has it too)
    cos, cos_tok = [], []
    for o_int8, seg in ((o8, None), (o8p, pseg)):
        o16, _ = mh_flash_forward(q, k, v, seg, rope, scale=scale)
        a8, a16 = o_int8.float(), o16.float()
        if seg is not None:          # pad tokens attend to pad alone: left out
            real = (seg == 0)[:, :, None, None]
            a8, a16 = a8 * real, a16 * real
        cos.append(F.cosine_similarity(a8.flatten(1), a16.flatten(1), dim=1).min().item())
        c = F.cosine_similarity(a8, a16, dim=3)
        cos_tok.append((c if seg is None else c[seg == 0]).min().item())
    check(min(cos) >= MIN_COSINE, f"int8 kernel vs the bf16 kernel: min row cosine "
          f"{min(cos):.6f} < {MIN_COSINE}")
    del o8, o8p, o16, a8, a16, c
    quantized = i8.int8_quantize_kernel(q, k, v, rope)
    q8, _, k8, _, v8t, _ = quantized
    _hold_int8_products(quantized, "the serving shape")
    ms = cuda_ms(lambda: i8.int8_flash_attention(q, k, v, scale=scale, rope=rope), 20)
    ms_pad = cuda_ms(lambda: i8.int8_flash_attention(
        q, k, v, scale=scale, segment_ids=pseg, rope=rope), 20)
    pro_ms = cuda_ms(lambda: i8.int8_quantize_kernel(q, k, v, rope), 20)
    attn_ms = cuda_ms(lambda: i8.int8_attention_from_quantized(
        quantized, scale=scale, dtype=q.dtype), 20)
    attn_pad_ms = cuda_ms(lambda: i8.int8_attention_from_quantized(
        quantized, scale=scale, dtype=q.dtype, segment_ids=pseg), 20)
    prod_ms = cuda_ms(lambda: r1.int8_products(q8, k8, v8t), 20)
    plain_ms = cuda_ms(lambda: i8.int8_flash_attention_plain(
        q, k, v, scale=scale, rope=rope), 3, warmup=1)
    prod_plain_ms = cuda_ms(lambda: r1.int8_products_plain(q8, k8, v8t), 3, warmup=1)
    bf16_ms = cuda_ms(lambda: mh_flash_forward(q, k, v, None, rope, scale=scale), 20)
    qr, kr = apply_rope_half(q, k, *rope)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (qr, kr, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), 20)
    del qr, kr, qh, kh, vh
    bound_ms, bound_by = _int8_bound(B, T, H, D, 2)
    walk_ops = 6.0 * B * T * T * H * D          # both walks' products
    tops = 4.0 * B * T * T * H * D / (ms * 1e-3) / 1e12
    print(f"int8_flash_fwd B={B} T={T} H={H} D={D} bf16 dense: call {ms:.4f} ms "
          f"({tops:.1f} TOP/s of the function's 4 B T^2 H D) = prologue alone "
          f"{pro_ms:.4f} ms (quant_qk + quant_v) + attention kernel alone {attn_ms:.4f} "
          f"ms ({walk_ops / (attn_ms * 1e-3) / 1e12:.1f} TOP/s of both walks' 6 B T^2 H D); "
          f"its products alone (int8_products) {prod_ms:.4f} ms "
          f"({walk_ops / (prod_ms * 1e-3) / 1e12:.1f} TOP/s, "
          f"{walk_ops / (prod_ms * 1e-3) / PEAK_INT8_OPS:.3f} of the int8 peak; plain "
          f"{prod_plain_ms:.4f} ms); padded {ms_pad:.4f} ms (attention alone "
          f"{attn_pad_ms:.4f}); plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
          f"({bound_by}; by the int8 dense rate "
          f"{1e3 * 4.0 * B * T * T * H * D / PEAK_INT8_OPS:.4f} ms), share of the bound "
          f"{bound_ms / ms:.3f}; for context, no library call computes this function: "
          f"the bf16 kernel mh_flash_fwd {bf16_ms:.4f} ms, SDPA bf16 {sdpa_ms:.4f} ms; "
          f"kernel vs plain at this shape max|do| dense {err_d:.3e}, padded {err_p:.3e}; "
          f"vs the bf16 kernel min batch-row cosine dense {cos[0]:.6f}, padded (real "
          f"tokens) {cos[1]:.6f} (threshold {MIN_COSINE}); least (token, head) cosine "
          f"{cos_tok[0]:.6f}, {cos_tok[1]:.6f}")
    return {"name": "int8_flash_fwd", "route": "cuda",
            "source": "omnibiote_tpu_torch/ops/csrc/int8_flash_fwd.cu",
            "replaces": "omnibiote_tpu/ops/int8_attention.py:48",
            "launches": None, "max_abs_err": max(err_d, err_p), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# ---------------------------------------------------------------------------
# 8. int8 products
# ---------------------------------------------------------------------------

def int8_gemm_phase():
    """quant_linear on the card at the serving batch's row count and the
    model's four weight shapes: exact int32 sums, and where its time goes."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.ops import quant

    M = 32 * 1024
    gen = torch.Generator(device="cuda").manual_seed(5)
    for K, N in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)):
        x = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = torch.randn(N, K, generator=gen, device="cuda") / math.sqrt(K)
        qw = quant.quantize_weight(w)
        wb = w.bfloat16()

        x_q, s_x = quant.quantize_rows(x)
        acc = quant._int8_matmul(x_q, qw.values)
        torch.cuda.synchronize()
        check(acc.dtype == torch.int32 and acc.shape == (M, N), "int8 product's result")
        # the same integers through float64, exact below 2^53
        want = (x_q.double() @ qw.values.double().t()).to(torch.int32)
        check(torch.equal(acc, want), f"int8 product at M={M} K={K} N={N} is not exact")
        del want
        # 16 rows or fewer go through the padded call
        small = quant._int8_matmul(x_q[:7], qw.values)
        check(torch.equal(small, acc[:7]), "int8 product of 7 rows (padded) differs")
        y = quant.quant_linear(x, qw)
        ref = F.linear(x, wb)
        cos = F.cosine_similarity(y.float(), ref.float(), dim=1).min().item()
        check(y.dtype == x.dtype and cos >= 0.999,
              f"quant_linear vs bf16 F.linear at K={K} N={N}: min row cosine {cos:.6f}")
        total = cuda_ms(lambda: quant.quant_linear(x, qw), 10)
        prod = cuda_ms(lambda: quant._int8_matmul(x_q, qw.values), 10)
        q_ms = cuda_ms(lambda: quant.quantize_rows(x), 10)
        resc = cuda_ms(lambda: quant.rescale(acc, s_x, qw.scale, None, x.dtype), 10)
        lin = cuda_ms(lambda: F.linear(x, wb), 10)
        print(f"quant_linear M={M} K={K} N={N}: int32 sums exact; {total:.4f} ms = int8 "
              f"product {prod:.4f} ({2.0 * M * K * N / (prod * 1e-3) / 1e12:.0f} TOP/s) + "
              f"quantise pass {q_ms:.4f} + rescale pass {resc:.4f}; bf16 F.linear "
              f"{lin:.4f} ms ({2.0 * M * K * N / (lin * 1e-3) / 1e12:.0f} TFLOP/s); min row "
              f"cosine vs it {cos:.6f}")
        del x, w, wb, x_q, s_x, acc, y, ref


# ---------------------------------------------------------------------------
# 9. int8 serving slice
# ---------------------------------------------------------------------------

# Quantized Encoder vs the bf16 Encoder, per row: the JAX tests' bar.
MIN_COSINE_INT8 = 0.99


def _min_row_cosine(a, b):
    import torch
    return torch.nn.functional.cosine_similarity(
        torch.from_numpy(a).double(), torch.from_numpy(b).double(), dim=1).min().item()


def int8_slice_phase(workdir, served):
    """Int8 serving at omnibiote-small full width and depth, on the model,
    tokenizer and sequences of the bf16 serving slice. Returns the launches
    of its main path (the int8-attention Encoder's runs)."""
    import torch
    from omnibiote_tpu_torch import api
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import attention as port_attention
    from omnibiote_tpu_torch.ops.int8_attention import int8_flash_attention_plain
    from omnibiote_tpu_torch.training.checkpoint import save_pytree_flat
    from omnibiote_tpu_torch.utils.convert import flatten_tree, jax_params_from_state

    sp, model, seqs, outs16 = served["sp"], served["model"], served["seqs"], served["outs"]
    cfg = model.cfg
    L, bs = cfg.n_layer, SERVING_BATCH
    n_batches = -(-len(seqs) // bs)

    def run(enc, runs, counter, other):
        """encode_sequences for `runs`; every layer of every batch must go
        through `counter`'s kernel and none through `other`'s."""
        outs = {}
        for method, masked in runs:
            before = dict(_kernels.LAUNCHES)
            out = enc.encode_sequences(seqs, method=method, batch_size=bs,
                                       mask_padding=masked)
            check(out.shape == (len(seqs), cfg.n_embd) and out.dtype.name == "float32"
                  and bool(torch.isfinite(torch.from_numpy(out)).all()),
                  f"int8 {method}/{masked}: shape {out.shape} dtype {out.dtype} or non-finite")
            check(_kernels.LAUNCHES[counter] - before[counter] == L * n_batches
                  and _kernels.LAUNCHES[other] == before[other],
                  f"int8 {method}/{masked}: launches {_kernels.LAUNCHES} after {before}, want "
                  f"{L} layers x {n_batches} batches of {counter} and none of {other}")
            outs[(method, masked)] = out
        return outs

    # -- int8 weights and int8 attention: this slice's main path ----------
    enc = api.Encoder(model, sp, quantize=True, quantize_attention=True, device="cuda")
    check(enc.cfg.attn_int8 and enc.cfg.qkv_prepermuted and not model.cfg.qkv_prepermuted,
          "Encoder(quantize=True, quantize_attention=True) configuration")
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    outs = run(enc, SERVING_RUNS, "int8_flash_fwd", "mh_flash_fwd")
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    want = _counts(int8_flash_fwd=L * n_batches * len(SERVING_RUNS))
    check(launches == want, f"int8 main path launched {launches}, want {want}")
    print(f"int8 slice: Encoder(quantize=True, quantize_attention=True), "
          f"{len(SERVING_RUNS)} encode_sequences calls in {wall:.2f} s, launches {launches}")

    # the same quantized model with the plain int8 attention on the card
    kernel_fn = port_attention.int8_flash_attention
    port_attention.int8_flash_attention = int8_flash_attention_plain
    try:
        plain = {key: enc.encode_sequences(seqs, method=key[0], batch_size=bs,
                                           mask_padding=key[1]) for key in SERVING_RUNS}
    finally:
        port_attention.int8_flash_attention = kernel_fn
    check(_kernels.LAUNCHES == launches, "the plain int8 run launched a kernel")
    worst_plain = min(_min_row_cosine(outs[key], plain[key]) for key in SERVING_RUNS)
    worst_bf16 = min(_min_row_cosine(outs[key], outs16[key]) for key in SERVING_RUNS)
    print(f"int8 slice: kernel path vs plain int8 attention, min row cosine "
          f"{worst_plain:.7f} (threshold {MIN_COSINE}); vs the bf16 Encoder "
          f"{worst_bf16:.6f} (threshold {MIN_COSINE_INT8})")
    check(worst_plain >= MIN_COSINE, "int8 Encoder: kernel vs plain int8 attention")
    check(worst_bf16 >= MIN_COSINE_INT8, "int8 Encoder vs the bf16 Encoder")
    rate_q8a = _encode_rate(enc.model, served["x"], "int8 weights + int8 attention")
    del enc, plain

    # -- int8 weights alone: what from_checkpoint and the CLI give --------
    enc_w = api.Encoder(model, sp, quantize=True, device="cuda")
    check(not enc_w.cfg.attn_int8, "Encoder(quantize=True) turned int8 attention on")
    runs_w = [("mean", True), ("mean", False)]
    outs_w = run(enc_w, runs_w, "mh_flash_fwd", "int8_flash_fwd")
    worst_w = min(_min_row_cosine(outs_w[key], outs16[key]) for key in runs_w)
    print(f"int8 slice: Encoder(quantize=True): {L} mh_flash_fwd launches a batch, no "
          f"int8_flash_fwd; vs the bf16 Encoder min row cosine {worst_w:.6f} "
          f"(threshold {MIN_COSINE_INT8})")
    check(worst_w >= MIN_COSINE_INT8, "Encoder(quantize=True) vs the bf16 Encoder")
    rate_q8 = _encode_rate(enc_w.model, served["x"], "int8 weights, bf16 attention")
    del enc_w

    # -- the FASTA CLI with --quantize, from a checkpoint of this model ---
    ckpt = os.path.join(workdir, "serve_ckpt")
    os.makedirs(ckpt)
    state = {n: p.detach().cpu() for n, p in model.state_dict().items()}
    save_pytree_flat(os.path.join(ckpt, "params.npz"),
                     flatten_tree(jax_params_from_state(state, cfg)))
    with open(os.path.join(ckpt, "meta.json"), "w") as f:
        json.dump({"model_cfg": dict(vars(cfg))}, f)
    fasta = os.path.join(workdir, "seqs.fa")
    with open(fasta, "w") as f:
        f.writelines(f">s{i}\n{s}\n" for i, s in enumerate(seqs))
    out_npz = os.path.join(workdir, "emb.npz")
    argv = ["--checkpoint", ckpt, "--fasta", fasta, "--out", out_npz,
            "--tokenizer-path", served["tok_path"], "--quantize"]
    print("FASTA CLI: python -m omnibiote_tpu_torch.api " + " ".join(argv))
    before = dict(_kernels.LAUNCHES)
    check(api.main(argv) == 0, "the FASTA CLI failed")
    import numpy as np
    with np.load(out_npz) as z:
        ids, emb = list(z["ids"]), z["embeddings"]
    cos_cli = _min_row_cosine(emb, outs_w[("mean", True)])
    check(ids == [f"s{i}" for i in range(len(seqs))] and emb.shape == (len(seqs), cfg.n_embd),
          "the FASTA CLI's ids or shape")
    check(_kernels.LAUNCHES["mh_flash_fwd"] - before["mh_flash_fwd"] == L * n_batches
          and _kernels.LAUNCHES["int8_flash_fwd"] == before["int8_flash_fwd"],
          f"the FASTA CLI with --quantize launched {_kernels.LAUNCHES} after {before}")
    check(cos_cli >= 0.9999, f"the FASTA CLI vs Encoder(quantize=True): {cos_cli:.7f}")
    print(f"FASTA CLI --quantize: {emb.shape[0]} embeddings, min row cosine vs "
          f"Encoder(quantize=True) on the same weights {cos_cli:.7f}")
    print(f"encode(mean) at B={SERVING_BATCH}, T={cfg.block_size}: int8 weights "
          f"{rate_q8:.1f} seq/s, int8 weights + int8 attention {rate_q8a:.1f} seq/s "
          f"(bf16: the serving slice's line above)")
    return launches


# ---------------------------------------------------------------------------
# 10. per-head entry: flash_attention(multi_head=False)
# ---------------------------------------------------------------------------

def per_head_phase():
    """flash_attention(multi_head=False): forward and backward against the
    plain versions, its launch counts, and each of its three kernels timed
    at bench.py's micro-batch. Returns (rows of flash_fwd, flash_bwd_dkv,
    flash_bwd_dq, launches of its main path)."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)

    def fwd_bwd(q, k, v, seg, do, **kw):
        q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(q, k, v, seg, None, scale=scale, block_q=512,
                               block_kv=512, multi_head=False, **kw)
        return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))

    n = 0
    for dtype in ("bfloat16", "float32"):
        for layout in ("packed", "dense"):
            for rate in (0.0, TRAIN_DROPOUT):
                B, T = 2, 1024
                q, k, v, seg, _ = _attn_inputs(B, T, H, D, getattr(torch, dtype),
                                               layout, seed=900 + n)
                gen = torch.Generator(device="cuda").manual_seed(950 + n)
                do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(q.dtype)
                kw = dict(dropout_rate=rate, seed=0xA5A5A5A5 + n)
                _kernels.reset_launches()
                got = fwd_bwd(q, k, v, seg, do, **kw)
                torch.cuda.synchronize()
                want_counts = _counts(flash_fwd=1, flash_bwd_dkv=1, flash_bwd_dq=1)
                check(_kernels.LAUNCHES == want_counts,
                      f"per-head entry launched {_kernels.LAUNCHES}, want {want_counts}")
                with _plain_attention():
                    # the kernels' tiles and order of rounding
                    tq, tkv = fa.KERNEL_TILES["fwd"][q.dtype]
                    want = fwd_bwd(q, k, v, seg, do, **kw)
                    po, _ = fa.mh_flash_forward_plain(q, k, v, seg, None, scale=scale,
                                                      block_kv=tkv, **kw)
                check(_kernels.LAUNCHES == want_counts, "the plain run launched a kernel")
                tag = f"B={B} T={T} {dtype:8s} {layout:6s} dropout {rate}"
                rt, at = TOL[dtype]["o"]
                check(torch.allclose(got[0].float(), po.float(), rtol=rt, atol=at),
                      f"per-head forward disagrees with its plain version at {tag}")
                rel, _ = _hold_bwd(got[1:], want[1:], dtype, f"per-head {tag}")
                print(f"per-head vs plain {tag}: max|do| {_abs_err(got[0], po):.3e} (rtol "
                      f"{rt}, atol {at}), backward max|d|/max|g| {rel:.2e} (tolerance "
                      f"{BWD_TOL[dtype]})")
                n += 1

    # bench.py's micro-batch: B=16, T=1024, bf16, 3 EOS a row, dropout 0.1;
    # this entry never skips, so every tile is walked
    B, T = TRAIN_SHAPE["B"], TRAIN_SHAPE["T"]
    q, k, v, _, _ = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 977)
    seg = torch.from_numpy(next(bench_batches(B, T, seed=977))["segments"]).cuda()
    gen = torch.Generator(device="cuda").manual_seed(978)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
    kw = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=31337)
    # main path: every count at 0 just before, read just after
    n_calls = 8
    _kernels.reset_launches()
    for _ in range(n_calls):
        got = fwd_bwd(q, k, v, seg, do, dropout_rate=TRAIN_DROPOUT, seed=31337)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    want_counts = _counts(flash_fwd=n_calls, flash_bwd_dkv=n_calls, flash_bwd_dq=n_calls)
    check(launches == want_counts, f"per-head main path launched {launches}, want {want_counts}")
    print(f"per-head main path: {n_calls} forward + backward calls of "
          f"flash_attention(multi_head=False) at B={B} T={T}, launches {launches}")

    o, lse = fa.mh_flash_forward(q, k, v, seg, None, **kw)
    di = (o.float() * do.float()).sum(-1)
    args = (q, k, v, do, lse, di, seg, None)
    shape = f"the per-head shape B={B} T={T}"
    err_f = _hold_fwd((o, lse), fa.mh_flash_forward_plain(
        q, k, v, seg, None, block_kv=fa.KERNEL_KV_TILE[torch.bfloat16], **kw),
        "bfloat16", shape)
    check(torch.equal(o, got[0]), "the per-head entry's o differs from its forward kernel's")
    want = fa.mh_flash_backward_plain(*args, **kw)
    rel_kv, err_kv = _hold_bwd(got[2:], want[1:], "bfloat16", f"{shape} (dkv)")
    rel_q, err_q = _hold_bwd(got[1:2], want[:1], "bfloat16", f"{shape} (dq)")
    del want
    ms = {"flash_fwd": cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, None, **kw), 20),
          "flash_bwd_dkv": cuda_ms(lambda: fa.mh_flash_bwd_dkv(*args, **kw), 20),
          "flash_bwd_dq": cuda_ms(lambda: fa.mh_flash_bwd_dq(*args, **kw), 20)}
    plain = {"flash_fwd": cuda_ms(lambda: fa.mh_flash_forward_plain(
                 q, k, v, seg, None, **kw), 3, warmup=1),
             "flash_bwd_dkv": cuda_ms(lambda: fa.mh_flash_bwd_dkv_plain(*args, **kw), 3, warmup=1),
             "flash_bwd_dq": cuda_ms(lambda: fa.mh_flash_bwd_dq_plain(*args, **kw), 3, warmup=1)}
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, dropout_p=TRAIN_DROPOUT, scale=scale), 20)
    pairs = _visible_pairs(seg, B, T)
    nb_fwd = 4 * B * T * H * D * 2 + B * T * H * 4      # no rope tables here
    bounds = {"flash_fwd": (_bound(4.0 * pairs * H * D, nb_fwd),
                            _bound(4.0 * B * T * T * H * D, nb_fwd)),
              "flash_bwd_dkv": (_bwd_bound(B, T, H, D, pairs, "dkv"),
                                _bwd_bound(B, T, H, D, None, "dkv")),
              "flash_bwd_dq": (_bwd_bound(B, T, H, D, pairs, "dq"),
                               _bwd_bound(B, T, H, D, None, "dq"))}
    print(f"per-head shape B={B} T={T} H={H} D={D} bf16, 3 EOS a row (visible share of "
          f"(q, k) pairs {pairs / (B * T * T):.4f}), dropout {TRAIN_DROPOUT}, no RoPE, every "
          f"tile walked; kernels vs plain: fwd max|do| {err_f:.3e}, max|d|/max|g| dkv "
          f"{rel_kv:.2e}, dq {rel_q:.2e}")
    for name in ms:
        (b_vis, by), (b_all, by_all) = bounds[name]
        print(f"  {name}: {ms[name]:.4f} ms, plain {plain[name]:.4f} ms, bound {b_vis:.4f} "
              f"ms over visible pairs ({by}), {b_all:.4f} over all ({by_all})"
              + (f", SDPA dense with dropout {sdpa_ms:.4f} ms" if name == "flash_fwd" else ""))
    rows = [{"name": name, "route": "cuda",
             "source": f"omnibiote_tpu_torch/ops/csrc/{src}",
             "replaces": f"omnibiote_tpu/ops/flash_attention.py:{line}",
             "launches": launches[name], "max_abs_err": err, "ms": ms[name],
             "plain_ms": plain[name], "bound_ms": bounds[name][0][0],
             "bound_by": bounds[name][0][1], "library_ms": lib}
            for name, src, line, err, lib in (
                ("flash_fwd", "mh_flash_fwd.cu", 110, err_f, sdpa_ms),
                ("flash_bwd_dkv", "mh_flash_bwd_dkv.cu", 240, err_kv, None),
                ("flash_bwd_dq", "mh_flash_bwd_dq.cu", 301, err_q, None))]
    return rows, launches


# ---------------------------------------------------------------------------
# 11. roofline probes
# ---------------------------------------------------------------------------

# Probe kernels vs their plain versions: the same bf16 rounding of S and o
# after fp32 sums in another order, which can move an element by a bf16 ulp;
# held as the forward, relative to max|o|.
PROBE_TOL = TOL["bfloat16"]["o"][0]


def _probe_calls(q, k, v, kx, bq, bkv, cta):
    """(name, kernel call, plain call) of the four probes at one shape and
    block pair, as their entry points run them; kx is k pre-transposed."""
    from omnibiote_tpu_torch.probes import roofline as r1, roofline2 as r2
    B, T, H, D = q.shape
    calls = [("roofline_dots", lambda: r1.dots_only(q, k, v, bq, bkv, cta_q=cta),
              lambda: r1.dots_only_plain(q, k, v, bq, bkv))]
    for nd in (3, 4):
        if bq <= bkv and (nd == 3 or bq == bkv) and bq % cta == 0:
            calls.append(("roofline_dots_n",
                          lambda nd=nd: r1.dots_n(q, k, v, bq, bkv, nd, cta_q=cta),
                          lambda nd=nd: r1.dots_n_plain(q, k, v, bq, bkv, nd)))
            calls.append(("roofline_dots_n",   # one CTA a work item
                          lambda nd=nd: r1._dots_n_kernel(q, k, v, bq, bkv, nd, cta_q=cta,
                                                          persistent=False),
                          lambda nd=nd: r1.dots_n_plain(q, k, v, bq, bkv, nd)))
    for kt in (False, True):
        kk = kx if kt else k
        calls.append(("roofline2_dots",
                      lambda kt=kt, kk=kk: r2.dots(q, kk, v, bq, bkv, kt, cta_q=cta),
                      lambda kt=kt, kk=kk: r2.dots_plain(q, kk, v, bq, bkv, kt)))
        if bkv >= H * D:
            calls.append(("roofline2_scores",
                          lambda kt=kt, kk=kk: r2.scores(q, kk, bq, bkv, kt, cta_q=cta),
                          lambda kt=kt, kk=kk: r2.scores_plain(q, kk, bq, bkv, kt)))
    return calls


# the CTA height of the wgmma probes' rows in the `kernels` line
PROBE_ROW_CTA = 128


def probe_phase():
    """The four probe kernels against their plain versions at the CPU
    test's shapes, at ragged T and at the probes' own, both CTA heights, kt
    0 and 1, the dots probe persistent and one CTA an item; the library's
    tile sizes against the Python copies the CPU mirror tests use; kernel,
    plain and library times and bounds at the probes' shape; both probe tables
    (`probes.roofline.main`, `roofline2.main`), whose launches are the rows'
    counts. Returns the four `kernels` rows."""
    import numpy as np
    import torch
    from omnibiote_tpu_torch.models.rope import rope_tables
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.probes import roofline as r1, roofline2 as r2

    def hold(name, got, want, tag):
        err = _abs_err(got, want)
        lim = PROBE_TOL * want.float().abs().max().item()
        check(torch.isfinite(got.float()).all() and err <= lim,
              f"{name} disagrees with its plain version at {tag}: max|do| "
              f"{err:.3e} > {lim:.3e}")
        return err

    # the CPU test's shapes (H = 2, values x 0.1, separate q, k, v)
    n = 0
    for B, T, pairs in ((1, 512, ((128, 256), (256, 256), (256, 128))),
                        (2, 256, ((128, 128), (128, 256)))):
        rng = np.random.default_rng(T + B)
        q, k, v = (r1.normal_bf16(rng, (B, T, 2, 128), "cuda") * 0.1 for _ in range(3))
        kx = r2.transposed_k(k)
        for bq, bkv in pairs:
            for cta in r1.CTA_ROWS:
                for name, kern, plain in _probe_calls(q, k, v, kx, bq, bkv, cta):
                    hold(name, kern(), plain(), f"B={B} T={T} bq={bq} bkv={bkv} cta={cta}")
                    n += 1
    # #1's, #2's and the split pair's kernels with their products alone (the
    # DOTS instances) on distinct q, k, v, do: a wrong wgmma descriptor or
    # swizzle gives plausible numbers
    for B, T in ((1, 512), (2, 256), (2, 1024)):
        rng = np.random.default_rng(7 * T + B)
        q, k, v, do = (r1.normal_bf16(rng, (B, T, 2, 128), "cuda") * 0.1 for _ in range(4))
        hold("mh_flash_fwd_dots", r1.fwd_products(q, k, v), r1.dots_only_plain(q, k, v, 128, 128),
             f"B={B} T={T}")
        for g, w, what in zip(r1.bwd_products(q, k, v, do), r1.bwd_products_plain(q, k, v, do),
                              ("dq", "dk", "dv")):
            hold("mh_flash_bwd_dots", g, w, f"B={B} T={T} ({what})")
        for g, w, what in zip(r1.dkv_products(q, k, v, do), r1.dkv_products_plain(q, k, v, do),
                              ("dk", "dv")):
            hold("mh_flash_bwd_dkv_dots", g, w, f"B={B} T={T} ({what})")
        hold("mh_flash_bwd_dq_dots", r1.dq_products(q, k, v, do),
             r1.dq_products_plain(q, k, v, do), f"B={B} T={T}")
        n += 7
    # the tiles tests/test_torch_probe_tiles.py mirrors are the built ones
    plib = _kernels.load_library("roofline_probes")
    tiles = {"roofline.KERNEL_KV_TILE": (r1.KERNEL_KV_TILE, plib.obt_roofline_tile(0)),
             "roofline2.SCORES_N_TILE": (r2.SCORES_N_TILE, plib.obt_roofline_tile(1)),
             "roofline2.SCORES_K_STEP": (r2.SCORES_K_STEP, plib.obt_roofline_tile(2)),
             "roofline.DOTS_N_CHUNK": (r1.DOTS_N_CHUNK, plib.obt_roofline_tile(3)),
             "roofline.DOTS_N_CHUNK_NARROW": (r1.DOTS_N_CHUNK_NARROW, plib.obt_roofline_tile(4))}
    for name_, (py, built) in tiles.items():
        check(py == built, f"{name_} = {py}, the library's tile is {built}")
    print(f"probe tiles (Python copy, library): {tiles}")
    # ragged T: a multiple of 64 and of cta_q = 64 but not of the 128-row kv
    # tile (the last tile reads zeros past T), and score tiles past H*D or
    # past T (j0 = T - block_kv > 0), both kt; dots persistent and one CTA
    # an item
    for T in (192, 320):
        rng = np.random.default_rng(3 * T)
        q, k, v = (r1.normal_bf16(rng, (2, T, 2, 128), "cuda") * 0.1 for _ in range(3))
        kx = r2.transposed_k(k)
        for pe in (True, False):
            tag = f"B=2 T={T} H=2 cta=64 persistent={pe}"
            hold("roofline_dots", r1.dots_kernel(q, k, v, kt=False, cta_q=64,
                                                 counter="roofline_dots", persistent=pe),
                 r1.dots_only_plain(q, k, v, 64, 64), tag)
            for kt, kk in ((False, k), (True, kx)):
                hold("roofline2_dots", r1.dots_kernel(q, kk, v, kt=kt, cta_q=64,
                                                      counter="roofline2_dots", persistent=pe),
                     r2.dots_plain(q, kk, v, 64, 64, kt), f"{tag} kt={int(kt)}")
            n += 3
        for H in (1, 2):
            qs, ks = (r1.normal_bf16(rng, (2, T, H, 128), "cuda") * 0.1 for _ in range(2))
            for bkv in (T, T // 2):
                if bkv < H * 128 or bkv % 8:
                    continue
                for kt, kk in ((False, ks), (True, r2.transposed_k(ks))):
                    hold("roofline2_scores", r2.scores_kernel(qs, kk, bkv, kt, cta_q=64),
                         r2.scores_plain(qs, kk, 64, bkv, kt),
                         f"B=2 T={T} H={H} block_kv={bkv} kt={int(kt)}")
                    n += 1
    # the dkv mix at kv tiles of 96 and 192 rows (TMA rows at any offset) and
    # block_q 64 or 192 (64-row q chunks), persistent and one CTA an item
    rng = np.random.default_rng(384)
    q, k, v = (r1.normal_bf16(rng, (2, 384, 2, 128), "cuda") * 0.1 for _ in range(3))
    for bq, bkv, nd, cta in ((64, 96, 3, 64), (192, 192, 3, 64), (192, 192, 4, 64),
                             (128, 192, 3, 64), (128, 192, 3, 128)):
        want = r1.dots_n_plain(q, k, v, bq, bkv, nd)
        for pe in (True, False):
            hold("roofline_dots_n", r1._dots_n_kernel(q, k, v, bq, bkv, nd, cta_q=cta,
                                                      persistent=pe), want,
                 f"B=2 T=384 H=2 bq={bq} bkv={bkv} {nd} products cta={cta} persistent={pe}")
            n += 1
    torch.cuda.synchronize()
    print(f"probe kernels vs plain: {n} small cases (H=2, T 256, 512 and 1024; ragged T 192, "
          f"320 and 384) within {PROBE_TOL} of max|o|")

    # the probes' shape and input (B=8, T=1024, H=8, unit normals, seed 0),
    # q passed as q, k and v as both tables do
    B, T, H, D = (r1.PROBE_SHAPE[c] for c in "BTHD")
    HD = H * D
    q = r1.normal_bf16(np.random.default_rng(0), (B, T, H, D), "cuda")
    kx = r2.transposed_k(q)
    err, omax = {}, {}
    for bq, bkv in ((512, 1024), (512, 512)):
        for cta in r1.CTA_ROWS:
            for name, kern, plain in _probe_calls(q, q, q, kx, bq, bkv, cta):
                want = plain()
                e = hold(name, kern(), want, f"the probes' shape bq={bq} bkv={bkv} cta={cta}")
                err[name] = max(err.get(name, 0.0), e)
                omax[name] = max(omax.get(name, 0.0), want.float().abs().max().item())
    # the dots probe one CTA a work item (the tables run it persistent)
    want_dots = r1.dots_only_plain(q, q, q, 512, 1024)
    for cta in r1.CTA_ROWS:
        for kt, kk in ((False, q), (True, kx)):
            tag = f"the probes' shape cta={cta} kt={int(kt)} one CTA an item"
            e = hold("roofline2_dots", r1.dots_kernel(q, kk, q, kt=kt, cta_q=cta,
                                                      counter="roofline2_dots",
                                                      persistent=False), want_dots, tag)
            err["roofline2_dots"] = max(err["roofline2_dots"], e)
    del want_dots
    prod_err = hold("mh_flash_fwd_dots", r1.fwd_products(q, q, q),
                    r1.dots_only_plain(q, q, q, 128, 128), "the probes' shape")
    bprod_err = max(hold("mh_flash_bwd_dots", g, w, f"the probes' shape ({what})")
                    for g, w, what in zip(r1.bwd_products(q, q, q, q),
                                          r1.bwd_products_plain(q, q, q, q), ("dq", "dk", "dv")))
    split_prod_err = max(
        *(hold("mh_flash_bwd_dkv_dots", g, w, f"the probes' shape ({what})")
          for g, w, what in zip(r1.dkv_products(q, q, q, q), r1.dkv_products_plain(q, q, q, q),
                                ("dk", "dv"))),
        hold("mh_flash_bwd_dq_dots", r1.dq_products(q, q, q, q),
             r1.dq_products_plain(q, q, q, q), "the probes' shape (dq)"))
    torch.cuda.synchronize()

    qb = q.permute(0, 2, 1, 3).reshape(B * H, T, D)
    kb = kx.view(B * H, D, T)
    x = q.view(B, T, HD)
    nbytes = 4 * B * T * HD * 2                 # q, k, v read, o written
    fwd = 4.0 * B * H * T * T * D
    j0 = T - 1024
    kern = dict(roofline_dots="dots_wgmma", roofline_dots_n="dots_n_wgmma",
                roofline2_dots="dots_wgmma", roofline2_scores="scores_wgmma")
    timed = {   # name: (what the row times, kernel, plain, library, flops, bytes)
        "roofline_dots": (
            f"dots_only cta={PROBE_ROW_CTA} persistent",
            lambda: r1.dots_only(q, q, q, 512, 1024, cta_q=PROBE_ROW_CTA),
            lambda: r1.dots_only_plain(q, q, q, 512, 1024),
            lambda: torch.matmul(torch.matmul(qb, qb.transpose(1, 2)), qb), fwd, nbytes),
        "roofline_dots_n": (
            f"dots_n 4 products bq=bkv=512 cta={PROBE_ROW_CTA} persistent",
            lambda: r1.dots_n(q, q, q, 512, 512, 4, cta_q=PROBE_ROW_CTA),
            lambda: r1.dots_n_plain(q, q, q, 512, 512, 4), None, 2 * fwd, nbytes),
        "roofline2_dots": (
            f"dots kt=1 cta={PROBE_ROW_CTA} persistent",
            lambda: r2.dots(q, kx, q, 512, 512, True, cta_q=PROBE_ROW_CTA),
            lambda: r2.dots_plain(q, kx, q, 512, 512, True),
            lambda: torch.matmul(torch.matmul(qb, kb), qb), fwd, nbytes),
        "roofline2_scores": (
            f"scores kt=0 cta={PROBE_ROW_CTA} persistent",
            lambda: r2.scores(q, q, 512, 1024, False, cta_q=PROBE_ROW_CTA),
            lambda: r2.scores_plain(q, q, 512, 1024, False),
            lambda: torch.matmul(x, x[:, j0:j0 + HD].transpose(1, 2)),
            2.0 * B * T * HD * HD, (2 * B * T * HD + B * HD * HD) * 2),
    }
    kernel_ms = {n_: graph_ms(t[1]) for n_, t in timed.items()}
    plain_ms = {n_: cuda_ms(t[2], 3, warmup=1) for n_, t in timed.items()}
    library_ms = {n_: (graph_ms(t[3]) if t[3] else None) for n_, t in timed.items()}
    # the same calls by CUDA events over back-to-back calls, as the probe
    # tables time them: host time and all, like for like with earlier readings
    events_ms = {n_: cuda_ms(t[1], 20) for n_, t in timed.items()}
    library_events_ms = {n_: (cuda_ms(t[3], 20) if t[3] else None) for n_, t in timed.items()}
    # every variant of the wgmma probes, and the library calls of both
    # layouts of k (graph-timed: device time without the host's share)
    variants = {}
    for cta in r1.CTA_ROWS:
        for kt, kk in ((False, q), (True, kx)):
            for pe in (True, False):
                key = f"cta={cta} {'persistent' if pe else 'a CTA an item'} kt={int(kt)}"
                variants[f"dots {key}"] = graph_ms(lambda: r1.dots_kernel(
                    q, kk, q, kt=kt, cta_q=cta, counter="roofline2_dots", persistent=pe))
            variants[f"scores cta={cta} persistent kt={int(kt)}"] = graph_ms(
                lambda: r2.scores_kernel(q, kk, 1024, kt, cta_q=cta))
        for nd in (3, 4):
            for pe in (True, False):
                variants[f"dots_n {nd} products cta={cta} "
                         f"{'persistent' if pe else 'a CTA an item'}"] = graph_ms(
                    lambda: r1._dots_n_kernel(q, q, q, 512, 512, nd, cta_q=cta, persistent=pe))
    fwd_products_ms = graph_ms(lambda: r1.fwd_products(q, q, q))
    scores_lib_kt1_ms = graph_ms(lambda: torch.matmul(x, kx[:, :, j0:j0 + HD]))
    for name_, ms in variants.items():
        print(f"  {name_}: {ms:.4f} ms")
    print(f"#10 at the probes' shape (graphs): persistent {variants['dots cta=128 persistent kt=0']:.4f}"
          f" / {variants['dots cta=64 persistent kt=0']:.4f} ms (cta 128 / 64), one CTA an item "
          f"{variants['dots cta=128 a CTA an item kt=0']:.4f} / "
          f"{variants['dots cta=64 a CTA an item kt=0']:.4f}; #1's own kernel with its products "
          f"alone (fwd_products) {fwd_products_ms:.4f}; two torch.matmul "
          f"{library_ms['roofline_dots']:.4f}; #12/#10 (kt=1/kt=0, cta 128 persistent) "
          f"{variants['dots cta=128 persistent kt=1'] / variants['dots cta=128 persistent kt=0']:.3f}")
    v11 = {k_[7:]: ms for k_, ms in variants.items() if k_.startswith("dots_n ")}
    print(f"#11 at the probes' shape (graphs, bq=bkv=512): 4 products "
          f"{v11['4 products cta=128 persistent']:.4f} / {v11['4 products cta=64 persistent']:.4f}"
          f" ms (cta 128 / 64, persistent), one CTA an item "
          f"{v11['4 products cta=128 a CTA an item']:.4f} / {v11['4 products cta=64 a CTA an item']:.4f};"
          f" 3 products {v11['3 products cta=128 persistent']:.4f} / "
          f"{v11['3 products cta=64 persistent']:.4f}; bound {_bound(2 * fwd, nbytes)[0]:.4f} / "
          f"{_bound(1.5 * fwd, nbytes)[0]:.4f} (4 / 3 products)")
    print(f"#13 at the probes' shape (graphs): kt=0 {variants['scores cta=128 persistent kt=0']:.4f}"
          f" ms, kt=1 {variants['scores cta=128 persistent kt=1']:.4f} (cta 128 persistent); "
          f"torch.matmul kt=0 {library_ms['roofline2_scores']:.4f}, kt=1 {scores_lib_kt1_ms:.4f}")
    qh = q.transpose(1, 2).contiguous()
    sdpa_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qh, qh, qh, scale=8.0 / 1024), 20)
    # the products at B=2, T=4096: as many CTAs, 32 kv tiles each instead
    # of 8, so a CTA's fixed cost (q rows in, first tiles, o out) weighs a
    # quarter
    q4 = q.reshape(2, 4 * T, H, D)
    prod_long_ms = cuda_ms(lambda: r1.fwd_products(q4, q4, q4), 20)
    # #2 whole on the same input, dense, without and with RoPE and dropout
    # (the training path's), to split it into its products and the rest
    scale = 8.0 / 1024
    bwd_full = {}
    for rope, rate in ((None, 0.0), (rope_tables(D, T, device="cuda"), TRAIN_DROPOUT)):
        o, lse = fa.mh_flash_forward(q, q, q, None, rope, scale=scale, dropout_rate=rate, seed=5)
        di = (o.float() * q.float()).sum(-1)
        bwd_full[rate] = cuda_ms(lambda: fa.mh_flash_backward_kernel(
            q, q, q, q, lse, di, None, rope, scale=scale, dropout_rate=rate, seed=5), 20)
    del qb, kb, x, qh, q4, o, lse, di

    # the probes' entry points: both tables, every count at 0 just before
    _kernels.reset_launches()
    t0 = time.time()
    table = {**r1.main(), **r2.main()}
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print(f"probe tables: {time.time() - t0:.1f} s, launches {launches}")
    full = table["full      fwd dense (no segment ids)"]
    prod = table["products  fwd #1's kernel (wgmma, 128-row tiles)"]
    dots = table["dots-only fwd bq=512 bkv=1024 cta=64"]  # events, through the wrapper
    print(f"#1 dense at B={B} T={T} (no dropout, no RoPE) {full:.4f} ms = its products "
          f"alone (wgmma, TMA ring, its own CTA) {prod:.4f} ms ({prod / full:.3f}, "
          f"{fwd / (prod * 1e-3) / 1e12:.1f} TFLOP/s) + softmax, scale and rescale "
          f"{full - prod:.4f} ms; the wgmma probe #10 {dots:.4f} ms; products vs "
          f"plain max|do| {prod_err:.3e}; the products at B=2 T={4 * T} {prod_long_ms:.4f} "
          f"ms ({4 * fwd / (prod_long_ms * 1e-3) / 1e12:.1f} TFLOP/s, as many CTAs with 4 x "
          f"the work each); SDPA {sdpa_ms:.4f} ms; kt=1/kt=0 "
          f"{table['dots kt=1 bq=512 bkv=512 cta=64'] / table['dots kt=0 bq=512 bkv=512 cta=64']:.3f}; "
          f"128-/64-row CTA: #10 {table['dots-only fwd bq=512 bkv=1024 cta=128'] / dots:.3f}, "
          f"#11 {table['dots-only 4-dot bq=512 bkv=512 cta=128'] / table['dots-only 4-dot bq=512 bkv=512 cta=64']:.3f}, "
          f"#13 {table['scores-only kt=0 bq=512 bkv=1024 cta=128'] / table['scores-only kt=0 bq=512 bkv=1024 cta=64']:.3f}")

    # the split pair's products alone beside the fused kernel's (graphs:
    # device time; the tables' lines are events)
    split_graph_ms = {"bwd_products": graph_ms(lambda: r1.bwd_products(q, q, q, q)),
                      "dkv_products": graph_ms(lambda: r1.dkv_products(q, q, q, q)),
                      "dq_products": graph_ms(lambda: r1.dq_products(q, q, q, q))}
    dkv_ev = table["products  dkv #4's kernel (wgmma, 64x128 tiles)"]
    dq_ev = table["products  dq  #5's kernel (wgmma, 128x64 tiles)"]
    print(f"split pair's products alone at B={B} T={T} (graphs): dkv_products "
          f"{split_graph_ms['dkv_products']:.4f} ms ({2 * fwd / (split_graph_ms['dkv_products'] * 1e-3) / 1e12:.1f} "
          f"TFLOP/s), dq_products {split_graph_ms['dq_products']:.4f} ms "
          f"({1.5 * fwd / (split_graph_ms['dq_products'] * 1e-3) / 1e12:.1f} TFLOP/s), together "
          f"{split_graph_ms['dkv_products'] + split_graph_ms['dq_products']:.4f} against "
          f"bwd_products {split_graph_ms['bwd_products']:.4f}; events {dkv_ev:.4f} / "
          f"{dq_ev:.4f}; the dkv mix #11 (dots_n_wgmma, 4 products, graphs) cta 128 "
          f"{v11['4 products cta=128 persistent']:.4f} / cta 64 "
          f"{v11['4 products cta=64 persistent']:.4f} ms, 3 products cta 64 "
          f"{v11['3 products cta=64 persistent']:.4f}; events at the table's line "
          f"{table['dots-only 4-dot bq=512 bkv=512 cta=64']:.4f}; "
          f"products vs plain max|d| {split_prod_err:.3e}")
    bprod = table["products  bwd #2's kernel (wgmma, 64x128 tiles)"]
    print(f"#2 dense at B={B} T={T} (no dropout, no RoPE) {bwd_full[0.0]:.4f} ms = its "
          f"products alone (wgmma, TMA ring, dq reduce-add, its own CTA) {bprod:.4f} ms "
          f"({bprod / bwd_full[0.0]:.3f}, {2.5 * fwd / (bprod * 1e-3) / 1e12:.1f} TFLOP/s) "
          f"+ scores, softmax and ds {bwd_full[0.0] - bprod:.4f} ms; with RoPE and dropout "
          f"{TRAIN_DROPOUT} {bwd_full[TRAIN_DROPOUT]:.4f} ms; the dkv mix #11 (4 products, "
          f"cta 128, graphs) {v11['4 products cta=128 persistent']:.4f} ms; products "
          f"vs plain max|d| {bprod_err:.3e}")

    # the probe tables' lines the rows were read from before the wgmma
    # rebuild (64-row CTAs, events)
    table_line = dict(roofline_dots="dots-only fwd bq=512 bkv=1024 cta=64",
                    roofline_dots_n="dots-only 4-dot bq=512 bkv=512 cta=64",
                    roofline2_dots="dots kt=1 bq=512 bkv=512 cta=64",
                    roofline2_scores="scores-only kt=0 bq=512 bkv=1024 cta=64")
    rows = []
    for name, line in (("roofline_dots", 54), ("roofline_dots_n", 163),
                       ("roofline2_dots", 68), ("roofline2_scores", 138)):
        what, _, _, _, flops, nb = timed[name]
        bound_ms, bound_by = _bound(flops, nb)
        script = "roofline2" if name.startswith("roofline2") else "roofline"
        lib, lib_ev = library_ms[name], library_events_ms[name]
        print(f"  {name} ({kern[name]}): {kernel_ms[name]:.4f} ms ({what}, graphs; events "
              f"{events_ms[name]:.4f}; events at the table's line '{table_line[name]}' "
              f"{table[table_line[name]]:.4f}), plain {plain_ms[name]:.4f} ms, library "
              f"{'none' if lib is None else f'{lib:.4f} ms (graphs; events {lib_ev:.4f})'}, "
              f"bound {bound_ms:.4f} ms ({bound_by}), max|do| vs plain {err[name]:.3e} "
              f"(max|o| {omax[name]:.3e})")
        rows.append({"name": f"{name}: {kern[name]}", "route": "cuda",
                     "source": "omnibiote_tpu_torch/ops/csrc/roofline_probes.cu",
                     "replaces": f"tools/probes/{script}.py:{line}",
                     "launches": launches[name], "max_abs_err": err[name],
                     "ms": kernel_ms[name], "plain_ms": plain_ms[name],
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib})
    return rows


# ---------------------------------------------------------------------------
# 12. eval slice
# ---------------------------------------------------------------------------

# The eval harness's batch lengths (evals/common.py::pad_batch buckets to
# 128, the token tasks cut at 1024) and its fine-tuning micro-batch
# (evals/engine.py: batch 4, accumulation 8).
EVAL_BUCKETS = (128, 256, 512, 1024)
EVAL_BATCH, EVAL_ACCUM = 4, 8
# Counters no eval path may touch: every T <= 1024 takes the fused
# single-kv backward, and the harness does not quantize.
EVAL_UNUSED = ("mh_flash_bwd_mk", "mh_flash_bwd_dkv", "mh_flash_bwd_dq",
               "int8_flash_fwd", "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def _pad_tail_lists(rng, B, T):
    """Token lists that pad_batch pads to T: one row of (T-128, T] tokens,
    the others of 1..T, each followed by PAD (segment id -1)."""
    lengths = [int(rng.integers(T - 127, T + 1))] + [
        int(rng.integers(1, T + 1)) for _ in range(B - 1)]
    return [rng.integers(20, 500, size=n).tolist() for n in lengths]


def _eval_kernel_cases(rng):
    """(B, T, tokens, segment ids) of the eval path's attention calls: B=4
    rows as pad_batch lays them out at each of EVAL_BUCKETS, and contact's
    top bucket, one row of 963..1023 real tokens and a PAD tail to T=1024
    (evals/contact.py::_pad_sample)."""
    import numpy as np
    from omnibiote_tpu_torch.config import PAD_TOKEN
    from omnibiote_tpu_torch.evals.common import pad_batch
    from omnibiote_tpu_torch.evals.contact import _pad_sample
    from omnibiote_tpu_torch.ops.segments import padding_segment_ids_np

    cases = []
    for T in EVAL_BUCKETS:
        x, seg = pad_batch(_pad_tail_lists(rng, EVAL_BATCH, T), 128, 1024)
        cases.append((EVAL_BATCH, T, x, seg))
    n = int(rng.integers(961, 1022))
    x = _pad_sample(rng.integers(20, 500, size=n + 2).tolist(),
                    *(np.zeros((n, n), np.float32) for _ in range(3)))[0]
    cases.append((1, 1024, x, padding_segment_ids_np(x, PAD_TOKEN)))
    return cases


def eval_kernel_phase():
    """#1 and #2 against their plain versions at the eval path's shapes:
    B=4, T in EVAL_BUCKETS, PAD-tail rows as pad_batch lays them out, and
    contact's B=1, T=1024 row with a PAD tail (with the skip bounds the
    model shares), bf16 and fp32, dropout 0 and 0.1. Returns the worst
    bf16 max |do| and max |d| of the backward."""
    import numpy as np
    import torch
    from omnibiote_tpu_torch.ops.flash_attention import (
        KERNEL_KV_TILE, SegmentBounds, mh_flash_backward, mh_flash_backward_plain,
        mh_flash_forward, mh_flash_forward_plain)

    H, D = 8, 128
    scale = 1.0 / math.sqrt(D)
    rng = np.random.default_rng(13)
    worst_f = worst_b = 0.0
    for i, (B, T, x, seg) in enumerate(_eval_kernel_cases(rng)):
        check(x.shape == (B, T), f"the eval path's tokens {x.shape}, want {(B, T)}")
        seg = torch.from_numpy(seg).cuda()
        bounds = SegmentBounds(seg)
        for dtype in ("bfloat16", "float32"):
            tdt = getattr(torch, dtype)
            q, k, v, _, rope = _attn_inputs(B, T, H, D, tdt, "dense", 300 + i)
            gen = torch.Generator(device="cuda").manual_seed(400 + i)
            do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(tdt)
            for rate in (0.0, TRAIN_DROPOUT):
                kw = dict(scale=scale, dropout_rate=rate, seed=0xE7A1 + 97 * i)
                what = f"the eval shape B={B} T={T} {dtype} dropout {rate}"
                got = mh_flash_forward(q, k, v, seg, rope, **kw, segment_skip=True,
                                       bounds=bounds)
                want = mh_flash_forward_plain(q, k, v, seg, rope, **kw,
                                              block_kv=KERNEL_KV_TILE[tdt])
                err_f = _hold_fwd(got, want, dtype, what)
                di = (want[0].float() * do.float()).sum(-1)
                bargs = (q, k, v, do, want[1], di, seg, rope)
                rel, err_b = _hold_bwd(
                    mh_flash_backward(*bargs, **kw, segment_skip=True, bounds=bounds),
                    mh_flash_backward_plain(*bargs, **kw), dtype, what)
                print(f"eval shape B={B} T={T} {dtype:8s} PAD tail (rows of "
                      f"{int((seg >= 0).sum(1).min())}..{int((seg >= 0).sum(1).max())} "
                      f"tokens) dropout {rate}: fwd max|do| {err_f:.3e}, bwd max|d|/max|g| "
                      f"{rel:.2e} (tolerances {TOL[dtype]['o']}, {BWD_TOL[dtype]})")
                if dtype == "bfloat16":
                    worst_f, worst_b = max(worst_f, err_f), max(worst_b, err_b)
    return worst_f, worst_b


def _bucketed_strings(sp, rng, alphabet, counts, extra_tokens):
    """counts[i] strings over `alphabet` whose token count (+ extra_tokens:
    tags, EOS) lies in (b - 128, b] for b = EVAL_BUCKETS[i]."""
    letters = list(alphabet)
    probe = "".join(rng.choice(letters, size=20000))
    chars_per_token = len(probe) / len(sp.encode(probe))
    out = []
    for b, n in zip(EVAL_BUCKETS, counts):
        got = 0
        while got < n:
            want = int(rng.integers(b - 120, b - 8)) - extra_tokens
            s = "".join(rng.choice(letters, size=max(1, int(want * chars_per_token))))
            if b - 128 < len(sp.encode(s)) + extra_tokens <= b:
                out.append(s)
                got += 1
    order = rng.permutation(len(out))
    return [out[i] for i in order]


PROTEIN = "ACDEFGHIKLMNPQRSTVWY"


def _eval_fixtures(root, sp, rng):
    """Synthetic datasets of every family in the layouts their loaders
    read, token lengths across EVAL_BUCKETS. Returns their paths."""
    mix = lambda n: [n // 2, n // 4, n // 8, n - n // 2 - n // 4 - n // 8]
    paths = {}
    # GUE: one 'tf' task, the class a 12-mer prefix
    task = os.path.join(root, "GUE", "tf", "0")
    os.makedirs(task)
    for name, n in (("train.csv", 32), ("dev.csv", 8), ("test.csv", 8)):
        seqs = _bucketed_strings(sp, rng, "ACGT", mix(n), 16)
        with open(os.path.join(task, name), "w") as f:
            f.write("sequence,label\n")
            for i, s in enumerate(seqs):
                f.write(("GGGGCCGGGGCC" if i % 2 else "ATATATATATAT") + s + f",{i % 2}\n")
    paths["gue"] = os.path.join(root, "GUE")

    def ss3(seq):
        return [0 if c in "AVLI" else 1 if c in "WFY" else 2 for c in seq]

    # ProteinGLUE SS3 (and the CB513 test set the SS3 head is tested on)
    pg = os.path.join(root, "ProteinGLUE")
    os.makedirs(pg)
    for name, n in (("ss_training", 32), ("ss_validation", 8), ("ss_test", 8),
                    ("ss_cb513_test", 8)):
        with open(os.path.join(pg, name + ".csv"), "w") as f:
            f.write("sequence,ss3\n")
            for s in _bucketed_strings(sp, rng, PROTEIN, mix(n), 3):
                f.write(f"{s},\"[{' '.join(map(str, ss3(s)))}]\"\n")
    paths["proteinglue"] = pg

    # TAPE fluorescence
    tape = os.path.join(root, "TAPE")
    os.makedirs(os.path.join(tape, "fluorescence"))
    for split, n in (("train", 32), ("valid", 8), ("test", 8)):
        seqs = _bucketed_strings(sp, rng, PROTEIN, mix(n), 3)
        recs = [{"primary": s, "log_fluorescence": [3.0 + s.count("W") / len(s)]}
                for s in seqs]
        with open(os.path.join(tape, "fluorescence", f"fluorescence_{split}.json"), "w") as f:
            json.dump(recs, f)
    paths["tape"] = tape

    # ProNAB: binding records with peptides across the buckets, and mutation
    # pairs of short peptides with 300-nt nucleotides, the mutant a fresh
    # string, so that wild and mutant predictions differ by more than a bf16
    # rounding of a random model's head (a constant ddG has no correlation)
    nuc = lambda n=40: "".join(rng.choice(list("ACGT"), size=n))
    ds = {f"P{k}": {"Sequence": p, "binding data": [
        [nuc(), "DNA", float(10 ** -rng.uniform(3, 9)), float(-rng.uniform(5, 15)), ""]]}
        for k, p in enumerate(_bucketed_strings(sp, rng, PROTEIN, mix(12), 24))}
    mutation_peptides = _bucketed_strings(sp, rng, PROTEIN, [4, 0, 0, 0], 24)
    paths["pronab_json"] = os.path.join(root, "pronab.json")
    with open(paths["pronab_json"], "w") as f:
        json.dump(ds, f)
    paths["mutation_jsonl"] = os.path.join(root, "mutation_data.jsonl")
    with open(paths["mutation_jsonl"], "w") as f:
        for p in mutation_peptides:
            for _ in range(2):
                f.write(json.dumps({
                    "peptide_sequence": p,
                    "wild_nucleotide_sequence": f"<DNA>{nuc(300)}<EOS>",
                    "mutated_nucleotide_sequence": f"<DNA>{nuc(300)}<EOS>",
                    "wild_G0": float(-rng.uniform(5, 15)),
                    "mutant_G0": float(-rng.uniform(5, 15))}) + "\n")

    # PDB contact: per-residue nearest-nucleotide distances
    recs = []
    for p in _bucketed_strings(sp, rng, PROTEIN, mix(8), 20):
        for _ in range(2):
            recs.append({"peptide_sequences": {"A": p},
                         "nucleotide_sequences": {"B": nuc()},
                         "closest_nucleotides": rng.uniform(2, 20, size=len(p)).tolist()})
    paths["distances_json"] = os.path.join(root, "distances.json")
    with open(paths["distances_json"], "w") as f:
        json.dump(recs, f)
    return paths


def _finite_numbers(tree):
    if isinstance(tree, dict):
        return all(_finite_numbers(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_finite_numbers(v) for v in tree)
    return math.isfinite(float(tree))


def _device_busy_ms(prof):
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if "cuda" in str(getattr(e, "device_type", "")).lower()) / 1e3


def eval_slice_phase(workdir, tok_path):
    """The fine-tuning eval harness at omnibiote-small full width: every
    family through its run_* entry point from a checkpoint on disk; the
    classifier's fine-tune on the kernels against the plain attention;
    rates, wall times, peak memory and the idle share of a fine-tune step.
    Returns the launches of the families' runs (summed)."""
    import contextlib
    import itertools
    import numpy as np
    import torch
    from omnibiote_tpu_torch import init_params, preset
    from omnibiote_tpu_torch.evals import (
        common, engine, gue, pdb_contact, pronab, proteinglue, tape, token_finetune)
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor
    from omnibiote_tpu_torch.training.checkpoint import (
        load_model_checkpoint, save_model_checkpoint)
    from omnibiote_tpu_torch.training.train import slot_seed

    root = os.path.join(workdir, "eval")
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir)
    sp = SentencePieceProcessor(tok_path)
    ban = sp.piece_to_id("▁")
    paths = _eval_fixtures(root, sp, np.random.default_rng(12))

    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT)
    check((cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.block_size, cfg.compute_dtype,
           cfg.param_dtype) == (8, 1024, 8, 1024, "bfloat16", "float32"),
          f"unexpected omnibiote-small config {cfg}")
    ckpt = os.path.join(root, "ckpt")
    model = init_params(torch.Generator(device="cuda").manual_seed(12), cfg, device="cuda")
    save_model_checkpoint(model, ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    print(f"eval slice: omnibiote-small {cfg.n_layer}L/{cfg.n_embd}d/{cfg.n_head}h vocab "
          f"{cfg.vocab_size} dropout {cfg.dropout}, {n_params} parameters (a best-on-val "
          f"snapshot copies {4 * n_params / 2**30:.2f} GiB), checkpoint {ckpt}")

    @contextlib.contextmanager
    def in_out_dir():
        cwd = os.getcwd()
        os.chdir(out_dir)
        try:
            yield
        finally:
            os.chdir(cwd)

    gue_log = []
    families = [
        ("gue", True, lambda: gue.run_gue(
            tok_path, ckpt, ban, gue_dir=paths["gue"], pretraining_epochs=1,
            pretraining_num_accum_steps=EVAL_ACCUM, batch_size=EVAL_BATCH,
            output_suffix="eval", seed=0, log=gue_log.append)),
        ("proteinglue SS3 frozen", False, lambda: proteinglue.run_proteinglue(
            tok_path, ckpt, banned_token=ban, eval_dir=paths["proteinglue"],
            output_suffix="frozen", tasks=["SS3"], num_epochs=2, batch_size=8,
            force_clean=True)),
        ("proteinglue SS3 train_backbone", True, lambda: proteinglue.run_proteinglue(
            tok_path, ckpt, banned_token=ban, eval_dir=paths["proteinglue"],
            output_suffix="backbone", tasks=["SS3"], num_epochs=1, batch_size=16,
            train_backbone=True)),
        ("tape fluorescence", False, lambda: tape.run_tape(
            tok_path, ckpt, banned_token=ban, tape_dir=paths["tape"],
            output_suffix="eval", tasks=["fluorescence"], num_epochs=2, batch_size=8)),
        ("pronab", True, lambda: pronab.run_pronab(
            tok_path, ckpt, "eval", pronab_json=paths["pronab_json"],
            mutation_jsonl=paths["mutation_jsonl"], banned_tokens=[ban],
            num_epochs_pretrain=1, num_epochs_cv=2, num_accumulation_steps=16,
            micro_batch=EVAL_BATCH, folds=2, save_pretrained=False)),
        ("pdb contact", True, lambda: pdb_contact.run_pdb_contact(
            ckpt, "eval", tok_path, distances_json=paths["distances_json"],
            banned_tokens=[ban], num_epochs=4, num_accumulation_steps=8,
            micro_batch=EVAL_BATCH, folds=2)),
    ]
    total = dict.fromkeys(_kernels.LAUNCHES, 0)
    for name, trains, run in families:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        # main path: every count at 0 just before, read just after
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        with in_out_dir():
            result = run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        print(f"eval {name}: {wall:.2f} s, peak allocated {peak / 2**30:.2f} GiB, "
              f"launches mh_flash_fwd {launches['mh_flash_fwd']} mh_flash_bwd "
              f"{launches['mh_flash_bwd']}; result {json.dumps(result)[:300]}")
        check(_finite_numbers(result), f"eval {name}: non-finite metrics {result}")
        check(launches["mh_flash_fwd"] > 0, f"eval {name} never launched mh_flash_fwd")
        check((launches["mh_flash_bwd"] > 0) == trains,
              f"eval {name}: {launches['mh_flash_bwd']} mh_flash_bwd launches "
              f"({'a trained' if trains else 'a frozen'} backbone)")
        check(all(launches[n] == 0 for n in EVAL_UNUSED),
              f"eval {name} launched a kernel off its path: {launches}")
        for n in total:
            total[n] += launches[n]
    with open(os.path.join(out_dir, "GUE_results_eval.csv")) as f:
        check(f.readline().strip() == "Task,MCC,F1", "GUE results CSV header")
    vals = [r["val_primary"] for r in gue_log if "val_primary" in r]
    n_snap = sum(v > max(vals[:i], default=-math.inf) for i, v in enumerate(vals))
    mlm = [r["loss"] for r in gue_log if r.get("phase") == "domain_mlm"]
    print(f"eval gue: domain-MLM losses {mlm}; {len(vals)} validations, "
          f"{n_snap} best-on-val snapshots (each a copy of every parameter, "
          f"{4 * n_params / 2**30:.2f} GiB, into one buffer kept on the card)")
    check(len(mlm) == 1 and math.isfinite(mlm[0]), f"domain-MLM losses {mlm}")

    # the classifier's fine-tune on the kernels against the plain attention:
    # dropout 0, the same weights, head, batches and seeds, 2 optimizer steps;
    # every validation counts as an improvement, so both return the model
    # after one update (validation precedes each step's update)
    model, cfg = load_model_checkpoint(ckpt)
    cfg0 = cfg.replace(dropout=0.0)
    X, Y, Xv, Yv, _, _ = gue.load_task(os.path.join(paths["gue"], "tf", "0"))
    tok = lambda xs: common.tokenize_sequences(sp, xs, "<DNA>", [ban])
    data = {"train": (tok(X), np.asarray([int(y) for y in Y])),
            "val": (tok(Xv), np.asarray([int(y) for y in Yv])),
            "test": (tok(Xv), np.asarray([int(y) for y in Yv]))}

    def classifier_run():
        logs, counter = [], itertools.count()
        _, _, aux = engine.finetune_classifier(
            model, cfg0, data, num_classes=2, num_epochs=2, batch_size=EVAL_BATCH,
            num_accumulation_steps=EVAL_ACCUM, lr=1e-3, embed_lr=1e-3, seed=0,
            max_len=cfg.block_size, metric_fn=lambda yt, yp: (next(counter), 0.0),
            log=logs.append)
        best = aux["params"]
        with torch.inference_mode():
            logits = torch.cat([engine.classify_logits(
                best["model"], best["head"], *common.to_device(
                    model, *common.pad_batch(data["val"][0][i:i + EVAL_BATCH], 128,
                                             cfg.block_size))).float()
                for i in range(0, len(data["val"][0]), EVAL_BATCH)])
        # the first micro-batch's gradients from the starting weights and head
        idx = np.random.default_rng(0).choice(len(data["train"][0]), EVAL_BATCH,
                                              replace=False)
        x, seg = common.pad_batch([data["train"][0][i] for i in idx], 128, cfg.block_size)
        head = common.init_linear_head(torch.Generator().manual_seed(0), cfg.n_embd, 2,
                                       device="cuda")
        loss = engine.classifier_loss(model, head, *common.to_device(
            model, x, seg, data["train"][1][idx]), deterministic=True)
        named = list(model.named_parameters()) + [("head.w", head["w"]), ("head.b", head["b"])]
        grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
        grads = {n: g for (n, _), g in zip(named, grads) if g is not None}
        return [r["loss"] for r in logs if "loss" in r], logits, grads

    _kernels.reset_launches()
    losses_k, logits_k, grads_k = classifier_run()
    check(_kernels.LAUNCHES["mh_flash_bwd"] > 0, "the kernel run launched no backward")
    launched = dict(_kernels.LAUNCHES)
    with _plain_attention():
        losses_p, logits_p, grads_p = classifier_run()
    check(_kernels.LAUNCHES == launched, "the plain run launched a kernel")
    worst_cos = min(torch.nn.functional.cosine_similarity(
        grads_k[n].double().flatten(), grads_p[n].double().flatten(), dim=0).item()
        for n in grads_k)
    row_cos = torch.nn.functional.cosine_similarity(
        logits_k.double(), logits_p.double(), dim=1).min().item()
    d_loss = max(abs(a - b) for a, b in zip(losses_k, losses_p))
    print(f"eval classifier fine-tune, kernels vs plain attention (dropout 0, B "
          f"{EVAL_BATCH} x accum {EVAL_ACCUM}, 2 steps): losses {losses_k} vs {losses_p} "
          f"(max |d| {d_loss:.2e}, limit {TRAIN_LOSS_ATOL}); worst first-micro-batch "
          f"gradient cosine {worst_cos:.6f} over {len(grads_k)} tensors (limit "
          f"{TRAIN_GRAD_COS}); val logits min row cosine {row_cos:.7f} (limit {MIN_COSINE})")
    check(len(losses_k) == len(losses_p) == 2, f"losses {losses_k} {losses_p}")
    check(d_loss <= TRAIN_LOSS_ATOL, "classifier fine-tune losses: kernels vs plain")
    check(worst_cos >= TRAIN_GRAD_COS, "classifier gradients: kernels vs plain")
    check(row_cos >= MIN_COSINE, "classifier val logits: kernels vs plain")
    del grads_k, grads_p

    # fine-tune rate at the GUE shape (B 4 x accum 8, dropout 0.1), the
    # idle share of one step, and the frozen-embedding rate
    ft = common.finetune_copy(model, cfg)
    head = common.init_linear_head(torch.Generator().manual_seed(1), cfg.n_embd, 2,
                                   device="cuda")
    opt, sched = common.make_finetune_optimizer(ft, head, lr=1e-4, embed_lr=1e-3,
                                                total_steps=1000)
    rng = np.random.default_rng(1)
    steps, warm = 6, 2
    batches = []
    for _ in range((steps + warm + 1) * EVAL_ACCUM):
        idx = rng.choice(len(data["train"][0]), EVAL_BATCH, replace=False)
        x, seg = common.pad_batch([data["train"][0][i] for i in idx], 128, cfg.block_size)
        batches.append(common.to_device(ft, x, seg, data["train"][1][idx]))

    def step(n):
        for j in range(EVAL_ACCUM):
            x, seg, y = batches[n * EVAL_ACCUM + j]
            loss = engine.classifier_loss(ft, head, x, seg, y, deterministic=False,
                                          rng=slot_seed(0, n, j))
            (loss / EVAL_ACCUM).backward()
        common.step_optimizer(opt, sched)

    for n in range(warm):
        step(n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in range(warm, warm + steps):
        step(n)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    timed = batches[warm * EVAL_ACCUM:(warm + steps) * EVAL_ACCUM]
    n_seq = len(timed) * EVAL_BATCH
    n_tok = sum(x.numel() for x, _, _ in timed)
    n_real = sum(int((s >= 0).sum()) for _, s, _ in timed)
    t_hist = {T: sum(x.shape[1] == T for x, _, _ in timed) for T in EVAL_BUCKETS}
    # one step (the last batches) timed alone, then the same step profiled:
    # the profiler's host cost stretches its own window, so the idle share is
    # the device's busy time over the unprofiled step's
    from torch.profiler import ProfilerActivity, profile
    t1 = time.perf_counter()
    step(warm + steps)
    torch.cuda.synchronize()
    alone_ms = 1e3 * (time.perf_counter() - t1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(warm + steps)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t1)
    busy_ms = _device_busy_ms(prof)
    check(busy_ms > 0, "the profiler recorded no device time in a fine-tune step")
    last_t = [x.shape[1] for x, _, _ in batches[-EVAL_ACCUM:]]
    print(f"eval fine-tune rate (omnibiote-small, B {EVAL_BATCH} x accum {EVAL_ACCUM}, "
          f"dropout {TRAIN_DROPOUT}, GUE fixture): {n_seq / dt:.2f} sequences/s, "
          f"{n_tok / dt:.1f} tokens/s ({n_real / dt:.1f} non-PAD tokens/s), "
          f"{1e3 * dt / steps:.3f} ms a step over {steps} steps; micro-batch T "
          f"{t_hist}; one step (T {last_t}) {alone_ms:.3f} ms alone, device busy "
          f"{busy_ms:.3f} ms in it (profiled window {window_ms:.3f} ms): idle share "
          f"{max(0.0, 1 - busy_ms / alone_ms):.3f}")
    del ft, head, opt, sched, batches

    X_pg = common.tokenize_sequences(sp, _bucketed_strings(
        sp, np.random.default_rng(3), PROTEIN, [32, 16, 8, 8], 3), "<protein>", [ban])
    token_finetune._batched_embeddings(model, cfg, X_pg[:8], 32, 128)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    emb = token_finetune._batched_embeddings(model, cfg, X_pg, 32, 128)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check(all(np.isfinite(e).all() for e in emb), "non-finite frozen embeddings")
    print(f"eval frozen-embedding rate (_batched_embeddings, batch 32, {len(X_pg)} "
          f"protein sequences of {min(map(len, X_pg))}..{max(map(len, X_pg))} tokens): "
          f"{len(X_pg) / dt:.2f} sequences/s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the domain MLM's fp32 logits over the 65,536-token vocabulary at the
    # harness's default batch: one micro-batch, forward and backward
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    toks = torch.randint(20, 65000, (32, cfg.block_size), device="cuda", dtype=torch.int32)
    seg = torch.zeros_like(toks)
    masked = torch.where(torch.rand(toks.shape, device="cuda") < 0.15, 2, toks)
    loss = engine.mlm_nonpad_loss(model, toks, seg, masked)
    loss.backward()
    torch.cuda.synchronize()
    check(math.isfinite(loss.item()), "non-finite domain-MLM loss")
    print(f"eval domain-MLM micro-batch B=32 T={cfg.block_size} (fp32 logits over "
          f"{cfg.vocab_size} tokens): peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, loss
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# 13. pretraining from raw records and the memory levers
# ---------------------------------------------------------------------------

GENBANK_MOLECULES = (("", "DNA"), ("", "mRNA"), ("ss-", "RNA"), ("", "rRNA"),
                     ("ds-", "DNA"), ("", "tRNA"), ("", "cRNA"))
AMINO = "ACDEFGHIKLMNPQRSTVWY"


# (batch, context, EOS a row) of the executed-tile check: bench.py's and
# bench_longctx.py's rows.
TILE_SHAPES = ((16, 1024, 3), (8, 2048, LONG_EOS), (4, 4096, LONG_EOS))
# The lever runs: (context, mini-batch, accumulation, EOS a row,
# checkpoint_freq, remat_policy, fused_ce).
LEVER_RUNS = (
    *[(1024, 16, 2, 3, cf, pol, fce) for fce in (False, True)
      for cf, pol in ((0, "full"), (1, "full"), (1, "dots"))],
    (4096, 4, 2, LONG_EOS, 0, "full", False),
    (4096, 4, 2, LONG_EOS, 1, "full", False),
    (4096, 8, 1, LONG_EOS, 1, "full", False),
)


def _write_raw_corpus(root, seed, n_files=2, n_records=150, n_proteins=1500):
    """A GenBank release's flat files (`gbsyn*.seq.gz`: LOCUS / ORIGIN
    records of several molecule types, sequences of 200-4000 nt) and a
    UniRef100-style FASTA (`uniref100.fasta.gz`, 50-700 residues a record,
    60 a line), from a numpy seed; returns the FASTA's path."""
    import gzip
    import numpy as np

    rng = np.random.default_rng(seed)

    def residues(alphabet, n):
        return np.frombuffer(alphabet.encode(), np.uint8)[
            rng.integers(0, len(alphabet), n)].tobytes().decode()

    for f in range(n_files):
        lines = []
        for r in range(n_records):
            strand, mol = GENBANK_MOLECULES[(f + r) % len(GENBANK_MOLECULES)]
            seq = residues("acgu" if "RNA" in mol else "acgt", int(rng.integers(200, 4000)))
            lines += [f"LOCUS       SYN{f}{r:05d}   {len(seq)} bp    {strand}{mol}     "
                      "linear   SYN 01-JAN-2026", "DEFINITION  synthetic record.",
                      "ORIGIN      "]
            for i in range(0, len(seq), 60):
                lines.append(f"{i + 1:>9} " + " ".join(
                    seq[j:j + 10] for j in range(i, min(i + 60, len(seq)), 10)))
            lines.append("//")
        with gzip.open(os.path.join(root, f"gbsyn{f + 1}.seq.gz"), "wt") as fh:
            fh.write("\n".join(lines) + "\n")
    fasta = os.path.join(root, "uniref100.fasta.gz")
    with gzip.open(fasta, "wt") as fh:
        for r in range(n_proteins):
            seq = residues(AMINO, int(rng.integers(50, 700)))
            fh.write(f">UniRef100_S{r:06d} synthetic n=1 Tax=X\n"
                     + "\n".join(seq[i:i + 60] for i in range(0, len(seq), 60)) + "\n")
    return fasta


def _corpus_to_shards(workdir):
    """Raw records -> tagged text -> a BPE vocabulary -> token shards, by the
    port's preprocessing modules and tokenizer CLI, on the host. Returns the
    shards' base dir (genbank/ and uniref100/, each with train/ and val/)."""
    import glob
    import gzip
    from omnibiote_tpu_torch.preprocessing import genbank, tokenize_corpus, uniprot
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor, train_cli

    raw, text, data = (os.path.join(workdir, d) for d in ("raw", "text", "shards"))
    os.makedirs(raw)
    t0 = time.time()
    fasta = _write_raw_corpus(raw, seed=13)
    print(f"corpus: synthetic raw records written in {time.time() - t0:.2f} s "
          f"({sum(os.path.getsize(p) for p in glob.glob(os.path.join(raw, '*')))} bytes "
          f"gzipped)")

    def records(paths):
        n = chars = 0
        for p in paths:
            with gzip.open(p, "rt") as fh:
                t = fh.read()
            n += t.count("<EOS>")
            chars += len(t)
        return n, chars

    t0 = time.time()
    counts = genbank.main(raw, os.path.join(text, "genbank"), workers=1)
    gb_txt = sorted(glob.glob(os.path.join(text, "genbank", "*.txt.gz")))
    n, chars = records(gb_txt)
    print(f"corpus: genbank.main {n} records ({counts}), {chars} characters, "
          f"{len(gb_txt)} files, {time.time() - t0:.2f} s")
    check(n == 2 * 150 and len(gb_txt) == 2, f"genbank.main wrote {n} records")
    t0 = time.time()
    n_shards = uniprot.main(fasta, os.path.join(text, "uniref100"), chunk_size=256 * 1024)
    ur_txt = sorted(glob.glob(os.path.join(text, "uniref100", "*.txt.gz")))
    n, chars = records(ur_txt)
    print(f"corpus: uniprot.main {n} records, {chars} characters, {n_shards} shards, "
          f"{time.time() - t0:.2f} s")
    check(n == 1500 and n_shards == len(ur_txt) > 1, f"uniprot.main wrote {n} records")
    tok = os.path.join(workdir, "corpus_bpe.model")
    t0 = time.time()
    train_cli.main([os.path.join(text, "*", "*.txt.gz"), tok, "--vocab_size", "4096"])
    sp = SentencePieceProcessor(tok)
    print(f"corpus: train_cli.main BPE vocabulary of {sp.vocab_size()} pieces in "
          f"{time.time() - t0:.2f} s")
    check(sp.vocab_size() == 4096, "train_cli.main vocabulary size")
    for name, paths in (("genbank", gb_txt), ("uniref100", ur_txt)):
        t0 = time.time()
        stats = tokenize_corpus.tokenize_to_shards(
            paths, os.path.join(data, name), sp, shard_tokens=100_000, val_fraction=0.05,
            n_threads=8, seed=13, prefix=name)
        print(f"corpus: tokenize_to_shards {name}: {stats['records']} records, "
              f"{stats['train_tokens']} train / {stats['val_tokens']} val tokens in "
              f"{stats['train_shards']} / {stats['val_shards']} shards, "
              f"{time.time() - t0:.2f} s")
        check(stats["train_tokens"] > 100_000 and stats["val_shards"] >= 1,
              f"tokenize_to_shards {name}: {stats}")
    return data


def _grads_equal(a, b):
    """Names of the gradients whose bits differ."""
    import torch
    return [n for n in a if not torch.equal(a[n], b[n])]


def _worst_cos(a, b):
    import torch
    return min(torch.nn.functional.cosine_similarity(
        a[n].double().flatten(), b[n].double().flatten(), dim=0).item() for n in a)


def _remat_exact(model, cfg, tokens, segments, label, fused_name, split_name):
    """One micro-batch's mlm_loss and gradients with checkpoint_freq 0, then
    1 'full', then 1 'dots': on the split pair (#4/#5) loss and gradients bit
    for bit; on the fused backward the loss bit for bit and the gradients
    within TRAIN_GRAD_COS. Returns the launches of the split runs."""
    import dataclasses
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.training.mlm import mlm_loss
    from omnibiote_tpu_torch.training.train import _compute_copy

    L = cfg.n_layer

    def loss_and_grads(cf, policy):
        model.cfg = dataclasses.replace(cfg, checkpoint_freq=cf, remat_policy=policy)
        params_c = _compute_copy(dict(model.named_parameters()), model.cfg)
        loss, _ = mlm_loss(model, tokens, segments, 4321, params=params_c)
        grads = torch.autograd.grad(loss, list(params_c.values()))
        return loss.detach(), dict(zip(params_c, grads))

    runs = (("none", 0, "full"), ("full", 1, "full"), ("dots", 1, "dots"))
    split_launches = {}
    try:
        for fused in (False, True):
            name = fused_name if fused else split_name
            with _attention_switch(FUSED_SINGLE_KV_BWD=fused, FUSED_MULTIKV_BWD=fused):
                out = {}
                for tag, cf, policy in runs:
                    _kernels.reset_launches()
                    out[tag] = loss_and_grads(cf, policy)
                    torch.cuda.synchronize()
                    if fused:
                        want = _counts(mh_flash_fwd=L * (2 if cf else 1), **{name: L})
                    else:
                        want = _counts(mh_flash_fwd=L * (2 if cf else 1),
                                       mh_flash_bwd_dkv=L, mh_flash_bwd_dq=L)
                        split_launches[tag] = dict(_kernels.LAUNCHES)
                    check(_kernels.LAUNCHES == want,
                          f"remat {tag} ({label}, {name}) launched {_kernels.LAUNCHES}, "
                          f"want {want}")
                # the no-remat run again: what the card gives twice without remat
                again = loss_and_grads(0, "full")
            base_loss, base = out["none"]
            rerun = _grads_equal(base, again[1])
            print(f"no remat twice ({label}, {name}): loss bit for bit "
                  f"{torch.equal(again[0], base_loss)}, gradients differing in any bit "
                  f"{len(rerun)} of {len(base)} {rerun[:4]}")
            for tag in ("full", "dots"):
                loss, grads = out[tag]
                differ = _grads_equal(base, grads)
                cos = _worst_cos(base, grads)
                print(f"remat {tag} vs none ({label}, {name}): loss {loss.item():.6f} vs "
                      f"{base_loss.item():.6f} (bit for bit: {torch.equal(loss, base_loss)}); "
                      f"gradients differing in any bit {len(differ)} of {len(grads)} "
                      f"{differ[:4]}; worst cosine {cos:.9f}")
                check(torch.equal(loss, base_loss), f"remat {tag} loss ({label}, {name})")
                if fused:
                    check(cos >= TRAIN_GRAD_COS, f"remat {tag} gradients ({label}, {name})")
                else:
                    check(not differ, f"remat {tag} gradients differ in {differ} ({label}, "
                                      f"{name})")
            del out, again
    finally:
        model.cfg = cfg
    return split_launches


def _lever_run(cfg, tc, n_eos, label, warmup=3, steps=5):
    """Step time, tokens/s, peak allocated memory, mfu and mfu_executed of
    Trainer.train_step_once over bench_batches rows (3 warm-up, 5 timed
    steps)."""
    import torch
    from omnibiote_tpu_torch import num_params
    from omnibiote_tpu_torch.training.metrics import (
        flops_per_token, flops_per_token_executed, kernel_skip_fractions, mfu)
    from omnibiote_tpu_torch.training.train import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with Trainer(cfg, tc, batch_iter=bench_batches(tc.batch_size, tc.ctx_len, 3, n_eos),
                 prefetch=2) as tr:
        for _ in range(warmup):
            tr.train_step_once()
        torch.cuda.synchronize()
        t0 = time.time()
        for _ in range(steps):
            m = tr.train_step_once()
        torch.cuda.synchronize()
        dt = time.time() - t0
        loss = float(m["loss"])
        n_params = num_params(tr.model, non_embedding=True)
    peak = torch.cuda.max_memory_allocated()
    _record_peak(cfg, tc, peak - base, base, f"lever run {label}")
    seg = next(bench_batches(tc.batch_size, tc.ctx_len, 3, n_eos))["segments"]
    fr = kernel_skip_fractions(seg, torch.bfloat16)
    fpt = flops_per_token(n_params, cfg.n_layer, cfg.n_embd, tc.ctx_len)
    fpt_x = flops_per_token_executed(n_params, cfg.n_layer, cfg.n_embd, tc.ctx_len,
                                     vocab_size=cfg.vocab_size, fractions=fr)
    tps = steps * tc.batch_size * tc.ctx_len / dt
    check(math.isfinite(loss), f"non-finite lever-run loss {loss} ({label})")
    row = dict(label=label, step_ms=1e3 * dt / steps, tokens_per_s=tps,
               peak_gib=peak / 2**30, mfu=mfu(tps, fpt), mfu_executed=mfu(tps, fpt_x))
    print(f"lever {label}: B={tc.batch_size} (mini {tc.mini_batch_size}) T={tc.ctx_len} "
          f"{n_eos} EOS a row, dropout {cfg.dropout} bf16: {row['step_ms']:.3f} ms a step, "
          f"{tps:.1f} tokens/s, peak allocated {row['peak_gib']:.3f} GiB, mfu "
          f"{row['mfu']:.4f}, mfu_executed {row['mfu_executed']:.4f} (executed tiles fwd "
          f"{fr[0]:.4f} bwd {fr[1]:.4f}; {fpt_x / 1e9:.4f} of {fpt / 1e9:.4f} GFLOP a "
          f"token), loss {loss:.4f}")
    return row


def pretrain_phase(workdir):
    """Pretraining from raw records at omnibiote-small width with the memory
    levers: corpus -> shards -> the CLI with remat; remat exact; the fused CE
    against the plain head; executed tiles against the kernels' counters;
    step time and peak memory of each lever. Returns the launches of its
    main-path run (the CLI)."""
    import dataclasses
    import json as _json
    import torch
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.models.omnibiota import init_params
    from omnibiote_tpu_torch.models.rope import rope_tables
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops.fused_ce import pick_chunks
    from omnibiote_tpu_torch.training import cli
    from omnibiote_tpu_torch.training.metrics import attention_tile_fraction, kernel_skip_fractions
    from omnibiote_tpu_torch.training.mlm import mlm_loss
    from omnibiote_tpu_torch.training.train import _compute_copy

    t_phase = time.time()
    root = os.path.join(workdir, "pretrain")
    os.makedirs(root)
    data = _corpus_to_shards(root)

    # -- the CLI on those shards with remat: this phase's main path ---------
    mini, accum, ctx = 16, 2, 1024
    L = 8
    log = os.path.join(root, "metrics.jsonl")
    steps = 4
    argv = ["--base_dir", data, "--train_type", "mixed", "--n_layer", str(L),
            "--n_embd", "1024", "--n_head", "8", "--ctx_len", str(ctx),
            "--dropout", str(TRAIN_DROPOUT), "--mini_batch_size", str(mini),
            "--batch_size", str(mini * accum), "--max_steps", str(steps),
            "--checkpoint_freq", "1", "--remat_policy", "dots",
            "--save_dir", os.path.join(root, "ckpt"), "--metrics_jsonl", log,
            "--log_every", "1", "--test_freq", "50000"]
    print("pretrain CLI: python -m omnibiote_tpu_torch.training.cli " + " ".join(argv))
    # main path: every count at 0 just before, read just after
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    trainer = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    check(trainer.model_cfg.checkpoint_freq == 1 and trainer.model_cfg.remat_policy == "dots",
          f"the CLI's model config {trainer.model_cfg}")
    del trainer
    torch.cuda.empty_cache()
    resumed = cli.run(argv[:argv.index("--max_steps")] + ["--max_steps", "1"]
                       + argv[argv.index("--max_steps") + 2:] + ["--resume_from", "-1"])
    torch.cuda.synchronize()
    main_launches = dict(_kernels.LAUNCHES)
    with open(log) as f:
        recs = [_json.loads(line) for line in f]
    losses = [r["loss"] for r in recs if "loss" in r]
    probes = [k for r in recs for k in r if k.startswith("test_loss/")]
    want = _counts(mh_flash_fwd=(steps + 1) * 2 * L * accum + len(probes) * L,
                   mh_flash_bwd=(steps + 1) * L * accum)
    print(f"pretrain CLI (remat dots): {steps} steps in {wall:.2f} s, 1 step resumed from "
          f"the checkpoint (step {resumed.step}); losses {[round(x, 4) for x in losses]}, "
          f"{len(probes)} validation probes; launches {main_launches} (want {want}: "
          f"mh_flash_fwd 2 x {L} and mh_flash_bwd {L} a micro-batch)")
    check(resumed.step == steps + 1, f"resumed pretrain run ended at step {resumed.step}")
    check(len(losses) == steps + 1 and all(math.isfinite(x) for x in losses),
          f"pretrain CLI losses {losses}")
    check(main_launches == want, f"pretrain CLI launches {main_launches}, want {want}")
    del resumed
    torch.cuda.empty_cache()

    # -- remat is exact: ctx 1024 (#2 / #4 + #5) and ctx 2048 (#3 / #4 + #5) --
    split = {}
    for (m, T, n_eos, fused_name) in ((mini, ctx, 3, "mh_flash_bwd"),
                                      (8, 2048, LONG_EOS, "mh_flash_bwd_mk")):
        cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                     block_size=T)
        batch = next(bench_batches(m, T, 21, n_eos))
        tokens = torch.from_numpy(batch["tokens"]).cuda()
        segments = torch.from_numpy(batch["segments"]).cuda()
        model = init_params(torch.Generator(device="cuda").manual_seed(21), cfg, device="cuda")
        split[T] = _remat_exact(model, cfg, tokens, segments, f"mini {m}, T {T}",
                                fused_name, "split pair")
        del model
        torch.cuda.empty_cache()

    # -- the fused CE against the plain head at ctx 1024, mini 16 -----------
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT)
    batch = next(bench_batches(mini, ctx, 22))
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    segments = torch.from_numpy(batch["segments"]).cuda()
    model = init_params(torch.Generator(device="cuda").manual_seed(22), cfg, device="cuda")
    out = {}
    for fused_ce in (False, True):
        model.cfg = dataclasses.replace(cfg, fused_ce=fused_ce)
        params_c = _compute_copy(dict(model.named_parameters()), model.cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        loss, _ = mlm_loss(model, tokens, segments, 99, params=params_c)
        grads = torch.autograd.grad(loss, list(params_c.values()))
        torch.cuda.synchronize()
        extra = (torch.cuda.max_memory_allocated() - base) / 2**30
        out[fused_ce] = loss.item(), dict(zip(params_c, grads)), extra
        del params_c, grads, loss
    model.cfg = cfg
    (lp, gp, mp), (lf, gf, mf) = out[False], out[True]
    cos = _worst_cos(gp, gf)
    print(f"fused CE vs the plain head (mini {mini}, T {ctx}, vocab {cfg.vocab_size}, "
          f"{pick_chunks(cfg.vocab_size)} chunks): loss {lf:.6f} vs {lp:.6f} (|d| {abs(lf - lp):.2e}, "
          f"limit {TRAIN_LOSS_ATOL}); worst gradient cosine {cos:.6f} (limit "
          f"{TRAIN_GRAD_COS}); a micro-batch's forward + backward peaks {mf:.3f} GiB above "
          f"the weights and their copy with the fused CE, {mp:.3f} GiB with the plain head")
    check(abs(lf - lp) <= TRAIN_LOSS_ATOL, "fused CE loss vs the plain head")
    check(cos >= TRAIN_GRAD_COS, "fused CE gradients vs the plain head")
    del model, out, gp, gf
    torch.cuda.empty_cache()

    # -- executed tiles: kernel_skip_fractions against the kernels' counters --
    H, D = 8, 128
    for (B, T, n_eos) in TILE_SHAPES:
        seg_np = next(bench_batches(B, T, 23, n_eos))["segments"]
        seg = torch.from_numpy(seg_np).cuda().contiguous()
        gen = torch.Generator(device="cuda").manual_seed(23)
        q, k, v, do = (torch.randn(B, T, H, D, generator=gen, device="cuda",
                                   dtype=torch.bfloat16) for _ in range(4))
        rope = rope_tables(D, T, 10000.0, device="cuda")
        sb = fa.SegmentBounds(seg)
        kw = dict(scale=0.125, dropout_rate=TRAIN_DROPOUT, seed=5)
        walked = {}
        for kind in ("fwd", "fused", "dkv", "dq"):
            bq, bkv = fa.KERNEL_TILES[kind][torch.bfloat16]
            owner, other = (bkv, bq) if kind in ("fused", "dkv") else (bq, bkv)
            count = torch.zeros(1, dtype=torch.int32, device="cuda")
            if kind == "fwd":
                o, lse2 = fa.mh_flash_forward_kernel(q, k, v, seg, rope, kv_bounds=sb.get(
                    owner, other), tile_count=count, **kw)
            else:
                di = (o.float() * do.float()).sum(-1)
                fa.mh_flash_bwd_kernel(kind, q, k, v, do, lse2, di, seg, rope,
                                       tile_bounds=sb.get(owner, other), tile_count=count,
                                       **kw)
            torch.cuda.synchronize()
            walked[kind] = int(count.item()) / (H * B * (T // owner) * (T // other))
            want_k = attention_tile_fraction(seg_np, owner, other)
            check(walked[kind] == want_k,
                  f"{kind} at T {T}: walked {walked[kind]} of its tiles, "
                  f"attention_tile_fraction {want_k}")
        e = kernel_skip_fractions(seg_np, torch.bfloat16)
        e_split = kernel_skip_fractions(seg_np, torch.bfloat16, fused=False)
        print(f"executed tiles B={B} T={T} ({n_eos} EOS a row): walked fwd {walked['fwd']:.6f} "
              f"fused {walked['fused']:.6f} dkv {walked['dkv']:.6f} dq {walked['dq']:.6f}; "
              f"kernel_skip_fractions {e[0]:.6f}, {e[1]:.6f} (split {e_split[1]:.6f})")
        check(e == (walked["fwd"], walked["fused"]), f"kernel_skip_fractions at T {T}")
        check(abs(e_split[1] - (3 * walked["dkv"] + walked["dq"]) / 4) < 1e-12,
              f"kernel_skip_fractions split at T {T}")
        del q, k, v, do, o, lse2
    torch.cuda.empty_cache()

    # -- what the levers cost ----------------------------------------------
    _kernels.reset_launches()
    rows = []
    for T, m, a, n_eos, cf, pol, fce in LEVER_RUNS:
        cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                     block_size=T, checkpoint_freq=cf, remat_policy=pol, fused_ce=fce)
        tc = TrainConfig(batch_size=m * a, mini_batch_size=m, ctx_len=T,
                         token_budget=float(m * a * T * 10000), seed=0)
        label = (f"ctx {T} mini {m} x {a}, remat {pol if cf else 'off'}, "
                 f"{'fused CE' if fce else 'plain head'}")
        rows.append(_lever_run(cfg, tc, n_eos, label))
    print(f"lever runs launched {dict(_kernels.LAUNCHES)}")
    print("levers: " + json.dumps(rows))
    print(f"pretrain phase: {time.time() - t_phase:.1f} s")
    return main_launches, split


# ---------------------------------------------------------------------------
# 14. the TAPE contact eval, DeePNAP and the pod-sharded checkpoint reader
# ---------------------------------------------------------------------------

# Inner-token counts of contact's fixture proteins (evals/contact.py buckets
# them to multiples of 64, the top bucket 1022): a split's first protein
# reaches the top bucket (T = 1024, the kernels), the others take the dense
# path at T = 66 and 322.
CONTACT_SPLITS = (("train", (1000, 300, 40)), ("valid", (990, 40)), ("test", (1010, 40)))
# Conv biases that a batch norm follows: their true gradient is 0, so the
# two runs' are rounding noise and no cosine of them means anything.
_PRE_BN_BIAS = re.compile(r"^cnn\.blocks\.\d+\.conv[12]\.bias$")


def _contact_fixtures(root, sp, rng):
    """ProteinNet JSON files whose proteins have CONTACT_SPLITS' inner-token
    counts (to a few tokens), W-W pairs the contacts (eval_tpu.py's
    geometry), one residue of each invalid."""
    import numpy as np
    probe = "".join(rng.choice(list(PROTEIN), size=20000))
    chars_per_token = len(probe) / len(sp.encode(probe))
    pn = os.path.join(root, "proteinnet")
    os.makedirs(pn)
    for split, counts in CONTACT_SPLITS:
        recs = []
        for want in counts:
            while True:
                seq = "".join(rng.choice(list(PROTEIN), size=int(want * chars_per_token)))
                inner = len(sp.encode("<protein>" + seq + "<EOS>")) - 2
                lo, hi = (961, 1022) if want > 960 else (want - 20, want + 20)
                if lo <= inner <= hi:
                    break
            tert = np.zeros((len(seq), 3))
            for i, ch in enumerate(seq):
                tert[i] = rng.uniform(-2, 2, size=3) if ch == "W" else (20.0 * (i + 2), 0, 0)
            valid = [1] * len(seq)
            valid[int(rng.integers(0, len(seq)))] = 0
            recs.append({"primary": seq, "tertiary": tert.tolist(), "valid_mask": valid})
        with open(os.path.join(pn, f"proteinnet_{split}.json"), "w") as f:
            json.dump(recs, f)
    return root


def _contact_two_steps(ckpt, sample, compute_dtype, seed=0):
    """Two optimizer steps of the contact fine-tune (dropout 0, the model in
    `compute_dtype`, the run's learning rates, the four-group AdamW after
    the global-norm clip) on one bucketed sample. Returns the losses, the
    first step's gradients by name and the predicted map before the first
    step and after the second."""
    import torch
    from omnibiote_tpu_torch.evals import common, contact
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint

    model, cfg = load_model_checkpoint(ckpt)
    model.cfg = cfg.replace(dropout=0.0, compute_dtype=compute_dtype)
    gen = torch.Generator().manual_seed(seed)
    head = common.init_linear_head(gen, cfg.n_embd, contact.HEAD_DIM, device="cuda")
    cnn = contact.init_contact_predictor(gen, device="cuda")
    opt, sched = contact.make_contact_optimizer(
        model, head, cnn, lr=1e-4, embed_lr=1e-4, head_lr=1e-3, contact_pred_lr=1e-3,
        total_steps=2)
    live = common.trainable(model, head)
    live.update({f"cnn.{n}": p for n, p in cnn.named_parameters()})
    tensors = common.to_device(model, *sample)
    out = {"losses": [], "grads": None,
           "map0": contact.predict_map(model, head, cnn, tensors[0], tensors[2])}
    for _ in range(2):
        loss = contact.contact_loss(model, head, cnn, *tensors, 1.0)
        loss.backward()
        out["losses"].append(loss.item())
        if out["grads"] is None:
            out["grads"] = {n: p.grad.detach().clone() for n, p in live.items()
                            if p.grad is not None and not _PRE_BN_BIAS.match(n)}
        contact.clip_grad_global_norm(live.values(), 1.0)
        common.step_optimizer(opt, sched)
    out["map2"] = contact.predict_map(model, head, cnn, tensors[0], tensors[2])
    return out


def _hold_contact_steps(ckpt, sample, n):
    """The contact fine-tune's two steps on the kernels against the plain
    attention, in bf16 (the main path's compute dtype) and fp32. The
    8-block CNN at its random init amplifies a difference in its input: a
    pair image that the two bf16 runs give within 2e-5 relative reaches the
    map's probabilities as up to 1.7e-2 (first chip run of this phase), so
    in bf16 the limits hold where the kernels act (the losses, the encoder's
    and the head's gradients, the map before any update) and the CNN's
    gradients and the map after two steps are printed; in fp32 the limits
    hold for every gradient and for the map after two steps."""
    from omnibiote_tpu_torch.ops import _kernels

    rows = lambda m: m[:n, :n].float().cpu().numpy()
    for dtype in ("bfloat16", "float32"):
        _kernels.reset_launches()
        k = _contact_two_steps(ckpt, sample, dtype)
        launched = dict(_kernels.LAUNCHES)
        check(launched["mh_flash_fwd"] > 0 and launched["mh_flash_bwd"] > 0,
              f"the {dtype} kernel run missed the kernels: {launched}")
        with _plain_attention():
            p = _contact_two_steps(ckpt, sample, dtype)
        check(_kernels.LAUNCHES == launched, "the plain run launched a kernel")
        d_loss = max(abs(a - b) for a, b in zip(k["losses"], p["losses"]))
        held = ([name for name in k["grads"] if not name.startswith("cnn.")]
                if dtype == "bfloat16" else list(k["grads"]))
        cos_held = _worst_cos({x: k["grads"][x] for x in held}, p["grads"])
        cos_cnn = _worst_cos({x: k["grads"][x] for x in k["grads"] if x.startswith("cnn.")},
                             p["grads"])
        map0 = _min_row_cosine(rows(k["map0"]), rows(p["map0"]))
        map2 = _min_row_cosine(rows(k["map2"]), rows(p["map2"]))
        print(f"contact fine-tune, {n} valid of the 1022 x 1022 pair image (T = "
              f"{sample[0].shape[1]}), {dtype}, kernels vs "
              f"plain attention (dropout 0, 2 steps): losses {k['losses']} vs {p['losses']} "
              f"(max |d| {d_loss:.2e}, limit {TRAIN_LOSS_ATOL}); worst first-step gradient "
              f"cosine {cos_held:.6f} over {len(held)} tensors{' (encoder and head)' if dtype == 'bfloat16' else ''} "
              f"(limit {TRAIN_GRAD_COS}; the 16 conv biases before a batch norm left out: their "
              f"gradient is 0 but for rounding), the CNN's {cos_cnn:.6f}; predicted map min row "
              f"cosine before the steps {map0:.7f}, after {map2:.7f} (limit {MIN_COSINE})")
        check(d_loss <= TRAIN_LOSS_ATOL, f"contact losses: kernels vs plain, {dtype}")
        check(cos_held >= TRAIN_GRAD_COS, f"contact gradients: kernels vs plain, {dtype}")
        check(map0 >= MIN_COSINE, f"contact predicted map: kernels vs plain, {dtype}")
        if dtype == "float32":
            check(map2 >= MIN_COSINE, "contact map after two steps: kernels vs plain, fp32")
        del k, p


def _contact_times(ckpt, sample, reps=3):
    """ms per sample of a grad step and of predict on one bucketed sample
    (dropout 0, the full 8-block CNN), each split into the CNN alone (on the
    pair image, detached) and the encoder with the head and the pair image
    (the difference); and the grad step's peak allocated memory."""
    import torch
    from omnibiote_tpu_torch.evals import common, contact
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint

    model, cfg = load_model_checkpoint(ckpt)
    model.cfg = cfg.replace(dropout=0.0)
    gen = torch.Generator().manual_seed(1)
    head = common.init_linear_head(gen, cfg.n_embd, contact.HEAD_DIM, device="cuda")
    cnn = contact.init_contact_predictor(gen, device="cuda")
    tok, cm, mk, ns = common.to_device(model, *sample)
    params = [*model.parameters(), *head.values(), *cnn.parameters()]

    def grad_step():
        contact.contact_loss(model, head, cnn, tok, cm, mk, ns, 1.0).backward()
        for p in params:
            p.grad = None

    feats = contact.pair_features(model, head, tok).detach().requires_grad_()

    def cnn_step():
        probs = cnn(feats, mk[None, None])[0, 0]
        (probs * cm).sum().backward()
        feats.grad = None
        for p in cnn.parameters():
            p.grad = None

    def predict():
        contact.predict_map(model, head, cnn, tok, mk)

    def cnn_predict():
        with torch.inference_mode():
            cnn(feats, mk[None, None])

    out = {}
    for name, fn in (("grad_step", grad_step), ("cnn_grad_step", cnn_step),
                     ("predict", predict), ("cnn_predict", cnn_predict)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0) / reps
    del feats
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    grad_step()
    torch.cuda.synchronize()
    out["grad_step_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def _deepnap_fixtures(root, rng, n_proteins=60):
    """ProNAB records (peptides of 50-1000 residues, 6-10 binding rows of
    10-60 nucleotides) and mutation pairs over 6 of their peptides."""
    nuc = lambda n: "".join(rng.choice(list("ACGT"), size=n))
    ds = {}
    for k in range(n_proteins):
        pep = "".join(rng.choice(list(PROTEIN), size=int(rng.integers(50, 1000))))
        ds[f"P{k}"] = {"Sequence": pep, "binding data": [
            [nuc(int(rng.integers(10, 60))), "DNA", float(10 ** -rng.uniform(3, 9)),
             float(-rng.uniform(5, 15)), ""] for _ in range(int(rng.integers(6, 11)))]}
    pronab = os.path.join(root, "deepnap_pronab.json")
    with open(pronab, "w") as f:
        json.dump(ds, f)
    mutations = os.path.join(root, "deepnap_mutations.jsonl")
    with open(mutations, "w") as f:
        for p in sorted(v["Sequence"] for v in ds.values())[:6]:
            for _ in range(3):
                f.write(json.dumps({
                    "peptide_sequence": p,
                    "wild_nucleotide_sequence": f"<DNA>{nuc(20)}<EOS>",
                    "mutated_nucleotide_sequence": f"<DNA>{nuc(20)}<EOS>",
                    "wild_G0": float(-rng.uniform(5, 15)),
                    "mutant_G0": float(-rng.uniform(5, 15))}) + "\n")
    return pronab, mutations


def _split_into_shards(src, dst, n=4):
    """A pod-sharded copy of a single-process checkpoint directory: every
    leaf of params.npz cut along its first axis into n pieces (a leaf of
    fewer rows stays whole), piece i in params.shard<i>.npz under the JAX
    package's "<leaf>@<start>:<stop>,..." key; meta.json copied."""
    import shutil
    import numpy as np
    os.makedirs(dst)
    files = [{} for _ in range(n)]
    with np.load(os.path.join(src, "params.npz")) as z:
        for key in z.files:
            leaf, suffix = (key[:-6], "::bf16") if key.endswith("::bf16") else (key, "")
            arr = z[key]
            rows = arr.shape[0] if arr.ndim else 0
            cuts = np.linspace(0, rows, n + 1).astype(int) if rows >= n else [0, rows]
            for i, (a, b) in enumerate(zip(cuts[:-1], cuts[1:])):
                spans = ",".join([f"{a}:{b}"] + [f"0:{d}" for d in arr.shape[1:]]) if arr.ndim else ""
                files[i][f"{leaf}@{spans}{suffix}"] = arr[a:b] if arr.ndim else arr
    for i, content in enumerate(files):
        np.savez(os.path.join(dst, f"params.shard{i}.npz"), **content)
    shutil.copy(os.path.join(src, "meta.json"), dst)
    return dst


def contact_phase(workdir, tok_path):
    """The TAPE contact eval at omnibiote-small full width from a checkpoint
    on disk, its fine-tune on the kernels against the plain attention, its
    per-sample times and memory at n = 1022; DeePNAP's run and its
    pretraining rate at batch 256; a 4-shard checkpoint loaded bit for bit.
    Returns the launches of the contact run (the main path)."""
    import numpy as np
    import torch
    from omnibiote_tpu_torch import init_params, preset
    from omnibiote_tpu_torch.evals import common, contact, deepnap
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor
    from omnibiote_tpu_torch.training.checkpoint import (
        load_model_checkpoint, save_model_checkpoint)
    from omnibiote_tpu_torch.training.train import slot_seed

    t_phase = time.time()
    root = os.path.join(workdir, "contact")
    out_dir = os.path.join(root, "out")
    os.makedirs(out_dir)
    sp = SentencePieceProcessor(tok_path)
    ban = sp.piece_to_id("▁")
    rng = np.random.default_rng(14)
    data_dir = _contact_fixtures(root, sp, rng)
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT)
    ckpt = os.path.join(root, "ckpt")
    model = init_params(torch.Generator(device="cuda").manual_seed(14), cfg, device="cuda")
    save_model_checkpoint(model, ckpt)
    del model
    torch.cuda.empty_cache()
    print(f"contact: cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}, "
          f"matmul.allow_tf32 {torch.backends.cuda.matmul.allow_tf32}")

    # main path: run_contact_eval, every count at 0 just before, read just after
    torch.cuda.reset_peak_memory_stats()
    cwd = os.getcwd()
    os.chdir(out_dir)
    _kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        result = contact.run_contact_eval(
            tok_path, ckpt, banned_token=ban, data_dir=data_dir, num_epochs=2,
            num_accumulation_steps=2, num_tests=1, seed=0, cache=True)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    wall = time.time() - t0
    launches = dict(_kernels.LAUNCHES)
    print(f"contact run_contact_eval (omnibiote-small, dropout {TRAIN_DROPOUT}, 8 blocks, "
          f"3 steps of 2 draws): {wall:.2f} s, peak allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches mh_flash_fwd "
          f"{launches['mh_flash_fwd']} mh_flash_bwd {launches['mh_flash_bwd']}; result "
          f"{json.dumps(result)}")
    check(_finite_numbers(result) and set(result) == {"test", "test_best"},
          f"contact: results {result}")
    check(launches["mh_flash_fwd"] > 0 and launches["mh_flash_bwd"] > 0,
          f"contact never reached the kernels: {launches}")
    check(all(launches[n] == 0 for n in EVAL_UNUSED),
          f"contact launched a kernel off its path: {launches}")
    cache = os.path.join(data_dir, "proteinnet", "processed_train_bpe_mixed.pkl")
    check(os.path.exists(cache), "contact wrote no preprocessing cache")

    # the fine-tune on the kernels against the plain attention, dropout 0:
    # the top-bucket training sample (read back from the cache), 2 steps
    with open(cache, "rb") as f:
        toks, cms, masks, nsrs = pickle.load(f)
    top = [i for i, t in enumerate(toks) if len(t) - 2 > 960]
    check(len(top) == 1, f"contact's train split has {len(top)} top-bucket samples")
    sample = contact._pad_sample(toks[top[0]], cms[top[0]], masks[top[0]], nsrs[top[0]])
    n = len(toks[top[0]]) - 2
    check(sample[0].shape == (1, 1024), f"top-bucket tokens {sample[0].shape}")
    _hold_contact_steps(ckpt, sample, n)
    torch.cuda.empty_cache()

    times = _contact_times(ckpt, sample)
    print(f"contact per sample, a 1022 x 1022 pair image with {n} valid (T = "
          f"{sample[0].shape[1]}, dropout 0, 8 blocks, on "
          f"{gpu_name_and_power()}): grad step {times['grad_step']:.2f} ms (CNN alone "
          f"{times['cnn_grad_step']:.2f} ms, encoder + head + pair image "
          f"{times['grad_step'] - times['cnn_grad_step']:.2f} ms by difference), predict "
          f"{times['predict']:.2f} ms (CNN alone {times['cnn_predict']:.2f} ms, encoder + head "
          f"+ pair image {times['predict'] - times['cnn_predict']:.2f} ms); grad step peak "
          f"allocated {times['grad_step_peak_gib']:.2f} GiB; cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}")

    # DeePNAP: run_deepnap with its CV, no attention kernel; its pretraining
    # rate at batch 256
    pronab, mutations = _deepnap_fixtures(root, rng)
    _kernels.reset_launches()
    os.chdir(out_dir)
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        dres = deepnap.run_deepnap(pronab, mutations, output_suffix="smoke", num_epochs=4,
                                   batch_size=256, folds=2, num_epochs_cv=64, seed=0)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    dwall = time.time() - t0
    check(_finite_numbers(dres) and len(dres["folds"]) == 2, f"deepnap: results {dres}")
    check(not any(_kernels.LAUNCHES.values()), f"deepnap launched {_kernels.LAUNCHES}")
    net = deepnap.init_deepnap(torch.Generator().manual_seed(0), device="cuda")
    opt, sched = common.adamw([list(net.parameters())], [common.linear_to_zero(1e-3, 1000)])
    xp = torch.from_numpy(np.stack([deepnap.encode_peptide("".join(rng.choice(
        list(PROTEIN), size=int(rng.integers(50, 1000)))))[None] for _ in range(256)])).cuda()
    xn = torch.from_numpy(np.stack([deepnap.encode_nucleotide(
        "".join(rng.choice(list("ACGT"), size=40)))[None] for _ in range(256)])).cuda()
    y = torch.randn(256, device="cuda")

    def pretrain_step(k):
        out = deepnap.apply_deepnap(net, xp, xn, dropout_rate=deepnap.PRETRAIN_DROPOUT,
                                    seed=slot_seed(1, k, 0))[:, 0]
        torch.mean((out - y) ** 2).backward()
        common.step_optimizer(opt, sched)

    for k in range(3):
        pretrain_step(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps = 50
    for k in range(steps):
        pretrain_step(3 + k)
    torch.cuda.synchronize()
    rate = steps / (time.perf_counter() - t0)
    print(f"deepnap run_deepnap (batch 256, 4 pretraining epochs, 2 CV folds of 64 epochs): "
          f"{dwall:.2f} s; zero-shot {json.dumps(dres['zero_shot'])}; pretraining "
          f"{rate:.1f} steps/s at batch 256 ({256 * rate:.0f} samples/s)")

    # a 4-shard checkpoint: the same weights, bit for bit
    sharded = _split_into_shards(ckpt, os.path.join(root, "ckpt_sharded"))
    check(not os.path.exists(os.path.join(sharded, "params.npz")), "the shards' dir")
    a, cfg_a = load_model_checkpoint(ckpt)
    b, cfg_b = load_model_checkpoint(sharded)
    sa, sb = a.state_dict(), b.state_dict()
    same = cfg_a == cfg_b and set(sa) == set(sb) and all(torch.equal(sa[k], sb[k]) for k in sa)
    print(f"sharded checkpoint: 4 params.shard*.npz files, {len(sa)} tensors, "
          f"{sum(v.numel() for v in sa.values())} values, loaded bit for bit equal: {same}")
    check(same, "the 4-shard checkpoint loaded other weights")
    del a, b, sa, sb
    torch.cuda.empty_cache()
    print(f"contact phase: {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 15. the multi-GPU modes at world size 1
# ---------------------------------------------------------------------------

PAR_RUNS = (("replicated", (1,)), ("fsdp", (1,)), ("replicated", (1, 1)),
            ("fsdp", (1, 1)), ("tp", (1, 1)), ("fsdp+tp", (1, 1)))
PAR_STEPS, PAR_TIMED = 3, 5


def _collective_ms(prof):
    """(device ms, host ms) of the profiled collectives: the c10d ops
    ('nccl:all_reduce', ...), each with the device work launched inside it
    (at one rank NCCL copies or does nothing)."""
    dev = host = 0.0
    for e in prof.key_averages():
        if e.key.startswith("nccl:"):
            dev += getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0))
            host += e.cpu_time_total
    return dev / 1e3, host / 1e3


def _par_run(cfg, tc, mesh, batches, label, timed=True):
    """PAR_STEPS steps of a Trainer (plain when mesh is None) on `batches`,
    their #1-#5 launches; with `timed`, then tokens/s over PAR_TIMED more
    steps, the peak memory the Trainer allocated over what was allocated
    before it, and, over 2 profiled steps, the collectives' device and host
    time a step and their share of the device time. Returns the metrics,
    the final parameters and the numbers."""
    import itertools
    import torch
    from torch.profiler import ProfilerActivity, profile
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.training.train import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = {"label": label}
    with Trainer(cfg, tc, batch_iter=itertools.chain(batches, bench_batches(
            tc.batch_size, tc.ctx_len, seed=77)), mesh=mesh) as tr:
        _kernels.reset_launches()
        ms = [tr.train_step_once() for _ in range(PAR_STEPS)]
        out["loss"] = [float(m["loss"]) for m in ms]
        out["grad_norm"] = [float(m["grad_norm"]) for m in ms]
        torch.cuda.synchronize()
        out["launches"] = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        out["params"] = {n: p.detach().clone() for n, p in tr.params.items()}
        if timed:
            torch.cuda.synchronize()
            t0 = time.time()
            for _ in range(PAR_TIMED):
                m = tr.train_step_once()
            torch.cuda.synchronize()
            dt = time.time() - t0
            check(math.isfinite(float(m["loss"])), f"{label}: non-finite loss")
            out["tokens_per_s"] = PAR_TIMED * tc.batch_size * tc.ctx_len / dt
            out["ms_a_step"] = 1e3 * dt / PAR_TIMED
            out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(2):
                    m = tr.train_step_once()
                float(m["loss"])
            busy = _device_busy_ms(prof)
            dev, host = _collective_ms(prof)
            out["coll_ms"], out["coll_host_ms"] = dev / 2, host / 2
            out["coll_share"] = dev / busy if busy else float("nan")
    torch.cuda.empty_cache()
    return out


def _update_cos(run, ref, init):
    """Worst per-tensor cosine between two runs' parameter updates."""
    import torch
    return min(torch.nn.functional.cosine_similarity(
        (run[n] - init[n]).double().flatten(), (ref[n] - init[n]).double().flatten(),
        dim=0).item() for n in init)


def parallel_phase(workdir, tok_path):
    """The sharded Trainer and Encoder(mesh=) over a one-rank NCCL group;
    returns the launches of its main path (every run of the sharded
    Trainer and the mesh Encoder) and of its split-pair runs."""
    import random
    import socket
    import numpy as np
    import torch
    import torch.distributed as dist
    from omnibiote_tpu_torch import init_params, preset
    from omnibiote_tpu_torch.api import Encoder
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.parallel.mesh import make_mesh
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
    from omnibiote_tpu_torch.training.train import Trainer

    t_phase = time.time()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"process group {dist.get_backend()} of {dist.get_world_size()}")
    mini, accum, ctx = 16, 2, 1024
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT)
    L = cfg.n_layer
    tc = TrainConfig(batch_size=mini * accum, mini_batch_size=mini, ctx_len=ctx,
                     token_budget=float(mini * accum * ctx * 10000), seed=0)
    gen = bench_batches(mini * accum, ctx, seed=11)
    batches = [next(gen) for _ in range(PAR_STEPS + 1)]
    # every Trainer draws the same initial weights from tc.seed
    with Trainer(cfg, tc) as tr0:
        init = {n: p.detach().clone() for n, p in tr0.params.items()}
    want_fused = _counts(mh_flash_fwd=PAR_STEPS * L * accum, mh_flash_bwd=PAR_STEPS * L * accum)
    want_fused = {k: v for k, v in want_fused.items() if v}

    # -- every mode against the plain Trainer, fused backward --------------
    plain = _par_run(cfg, tc, None, batches, "plain")
    check(plain["launches"] == want_fused, f"plain launches {plain['launches']}")
    main = dict.fromkeys(_kernels.LAUNCHES, 0)
    rows = [plain]
    for mode, shape in PAR_RUNS:
        mesh = make_mesh(shape, ("data", "model")[:len(shape)])
        run = _par_run(cfg, tc.replace(sharding=mode), mesh, batches, f"{mode} {shape}")
        for k, v in run["launches"].items():
            main[k] += v
        dloss = max(abs(a - b) for a, b in zip(run["loss"], plain["loss"]))
        dgn = max(abs(a - b) / b for a, b in zip(run["grad_norm"], plain["grad_norm"]))
        cos = _update_cos(run["params"], plain["params"], init)
        exact = all(torch.equal(run["params"][n], plain["params"][n]) for n in init)
        print(f"parallel {mode} {shape}: losses {[round(x, 6) for x in run['loss']]} "
              f"(plain {[round(x, 6) for x in plain['loss']]}, |d| {dloss:.2e}, limit "
              f"{TRAIN_LOSS_ATOL}); grad_norm relative {dgn:.2e} (limit {TRAIN_GNORM_RTOL}); "
              f"worst update cosine {cos:.6f} (limit {TRAIN_GRAD_COS}); parameters bit "
              f"for bit: {exact}; launches {run['launches']}")
        check(run["launches"] == want_fused, f"{mode} {shape} launches {run['launches']}")
        check(dloss <= TRAIN_LOSS_ATOL and dgn <= TRAIN_GNORM_RTOL
              and cos >= TRAIN_GRAD_COS, f"{mode} {shape} differs from the plain Trainer")
        del run["params"]
        rows.append(run)
    del plain["params"]

    # -- the split pair: bit for bit, and a pod-sharded resume -------------
    split = dict.fromkeys(_kernels.LAUNCHES, 0)
    want_split = {"mh_flash_fwd": PAR_STEPS * L * accum,
                  "mh_flash_bwd_dkv": PAR_STEPS * L * accum,
                  "mh_flash_bwd_dq": PAR_STEPS * L * accum}
    with _attention_switch(FUSED_SINGLE_KV_BWD=False):
        ref = _par_run(cfg, tc, None, batches, "plain, split pair", timed=False)
        tcf = tc.replace(sharding="fsdp", save_dir=os.path.join(workdir, "par_ckpt"))
        mesh = make_mesh((1,), ("data",))
        _kernels.reset_launches()
        with Trainer(cfg, tcf, batch_iter=iter(batches), mesh=mesh) as tr:
            ms = [tr.train_step_once() for _ in range(PAR_STEPS)]
            torch.cuda.synchronize()
            launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
            exact = ([float(m["loss"]) for m in ms] == ref["loss"] and all(
                torch.equal(tr.params[n], ref["params"][n]) for n in init))
            path = tr.save_checkpoint()
            step4 = tr.train_step_once()
            after = {n: p.detach().clone() for n, p in tr.params.items()}
        for k, v in launches.items():
            split[k] += v
        files = sorted(os.listdir(path))
        reloaded, _ = load_model_checkpoint(path)
        same_reload = all(torch.equal(p, ref["params"][n])
                          for n, p in reloaded.named_parameters())
        del reloaded
        with Trainer(cfg, tcf.replace(seed=5), batch_iter=iter(batches[PAR_STEPS:]),
                     mesh=mesh) as t2:
            t2.restore_checkpoint(path)
            r4 = t2.train_step_once()
            resumed = (t2.step == PAR_STEPS + 1
                       and float(r4["loss"]) == float(step4["loss"])
                       and all(torch.equal(t2.params[n], after[n]) for n in after))
    print(f"parallel split pair, fsdp (1,): {PAR_STEPS} steps bit for bit with the plain "
          f"Trainer: {exact}; launches {launches} (want {want_split}); pod-sharded "
          f"checkpoint {files}, reloaded bit for bit: {same_reload}; step "
          f"{PAR_STEPS + 1} resumed from it bit for bit: {resumed} (loss "
          f"{float(r4['loss']):.6f})")
    check(launches == want_split, f"split-pair launches {launches}")
    check(exact, "fsdp on the split pair differs from the plain Trainer")
    check(files == ["meta.json", "opt_state.shard0.npz", "params.shard0.npz"],
          f"pod-sharded checkpoint files {files}")
    check(same_reload and resumed, "the pod-sharded resume is not exact")
    del ref, after

    # -- Encoder(mesh=) on the serving slice's sequences -------------------
    rng = random.Random(0)
    _sequences(rng, 400, 40, 400)
    seqs = _sequences(rng, 64, 10, 6000)
    sp = SentencePieceProcessor(tok_path)
    model = init_params(torch.Generator(device="cuda").manual_seed(0),
                        preset("omnibiote-small", vocab_size=65536, dropout=0.0),
                        device="cuda")
    single = Encoder(model, sp).encode_sequences(seqs, method="mean", batch_size=SERVING_BATCH)
    _kernels.reset_launches()
    dp = Encoder(model, sp, mesh=make_mesh((1,), ("data",))).encode_sequences(
        seqs, method="mean", batch_size=SERVING_BATCH)
    torch.cuda.synchronize()
    for k, v in _kernels.LAUNCHES.items():
        main[k] += v
    enc_exact = bool(np.array_equal(single, dp))
    print(f"parallel Encoder(mesh=(1,)): {len(seqs)} sequences, embeddings equal to the "
          f"single-device Encoder's bit for bit: {enc_exact} (max |d| "
          f"{float(np.abs(single - dp).max()):.2e}); launches {_kernels.LAUNCHES['mh_flash_fwd']}")
    check(enc_exact and _kernels.LAUNCHES["mh_flash_fwd"] > 0,
          "Encoder(mesh=) differs from the single-device Encoder")
    del model

    for r in rows:
        print(f"parallel throughput {r['label']}: {r['tokens_per_s']:.1f} tokens/s "
              f"({r['tokens_per_s'] / plain['tokens_per_s']:.4f} of plain), "
              f"{r['ms_a_step']:.3f} ms a step, peak allocated by the Trainer "
              f"{r['peak_gib']:.2f} GiB, collectives {r['coll_ms']:.3f} ms of device "
              f"time a step ({100 * r['coll_share']:.2f} %) and {r['coll_host_ms']:.3f} ms "
              f"on the host")
    dist.destroy_process_group()
    print(f"parallel phase: {time.time() - t_phase:.1f} s")
    return main, split


# ---------------------------------------------------------------------------
# 16. sequence parallelism
# ---------------------------------------------------------------------------

SP_H, SP_D = 8, 128
# (T of a ring block, rows cut into n blocks, dtype, dropout): q = member
# n - 1's block, kv = block n - 2 (the one its first rotation brings it)
SP_KERNEL_CASES = [(2048, 2, dt, rate) for dt in ("bfloat16", "float32")
                   for rate in (0.0, TRAIN_DROPOUT)]
SP_KERNEL_CASES += [(1024, 4, "bfloat16", TRAIN_DROPOUT), (1024, 4, "float32", 0.0)]
SP_CTX, SP_MINI, SP_ACCUM, SP_STEPS = 4096, 4, 2, 3
_RING_KERNELS = ("mh_fwd", "mh_bwd", "dq_epilogue", "rope_rows")


def _sp_pair(B, T, n, seed):
    """(q ids, kv ids) (B, T) of the last member of a ring of n and the
    block its first rotation brings it (block n - 2): rows of n·T positions
    with bench_longctx.py's five EOS, cut into n blocks."""
    seg = _long_segments("packed", B, n * T, seed)
    return seg[:, (n - 1) * T:].contiguous(), seg[:, (n - 2) * T:(n - 1) * T].contiguous()


def _sp_kernel_checks():
    """#1-#5 with q ids != kv ids against their plain versions, skipping on
    against off, and a copy of the ids against the one array. Returns the
    worst bf16 max |do| of the forward and max |d| of the backwards."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa

    B, H, D = 4, SP_H, SP_D
    scale = 1.0 / math.sqrt(D)
    worst = {"fwd": 0.0, "bwd": 0.0}
    for i, (T, n, dtype, rate) in enumerate(SP_KERNEL_CASES):
        tdt = getattr(torch, dtype)
        tag = f"B={B} T={T} (block {n - 1} of {n} against {n - 2}) {dtype} dropout {rate}"
        q, k, v, _, _ = _attn_inputs(B, T, H, D, tdt, "dense", seed=900 + i)
        q_ids, kv_ids = _sp_pair(B, T, n, 900 + i)
        sees = (q_ids[:, :, None] == kv_ids[:, None, :]).any(-1)      # (B, T)
        gen = torch.Generator(device="cuda").manual_seed(950 + i)
        # the ring's combine gives a q row that sees none of the block a
        # weight of exactly 0: its o and lse then carry no cotangent
        do = (torch.randn(B, T, H, D, generator=gen, device="cuda")
              * sees[..., None, None]).to(tdt)
        dlse = torch.randn(B, T, H, generator=gen, device="cuda") * sees[..., None]
        kw = dict(scale=scale, dropout_rate=rate, seed=0x5EED + i, kv_segment_ids=kv_ids)
        sb = fa.SegmentBounds(q_ids, kv_ids)
        tq, tkv = fa.KERNEL_TILES["fwd"][tdt]
        bq, bkv = fa.KERNEL_TILES["fused"][tdt]
        o, lse = fa.mh_flash_forward(q, k, v, q_ids, None, segment_skip=True, bounds=sb, **kw)
        o_all, lse_all = fa.mh_flash_forward(q, k, v, q_ids, None, **kw)
        po, plse = fa.mh_flash_forward_plain(q, k, v, q_ids, None, block_q=tq, block_kv=tkv,
                                             segment_skip=True, bounds=sb, **kw)
        err_f = _hold_fwd((o, lse), (po, plse), dtype, tag)
        fwd_same = torch.equal(o[sees], o_all[sees]) and torch.equal(lse[sees], lse_all[sees])
        di = (po.float() * do.float()).sum(-1) - dlse
        args = (q, k, v, do, plse, di, q_ids, None)
        want = fa.mh_flash_backward_plain(*args, block_q=bq, block_kv=bkv, segment_skip=True,
                                          bounds=sb, **kw)
        fused = fa.mh_flash_backward(*args, segment_skip=True, bounds=sb, **kw)
        fused_all = fa.mh_flash_backward(*args, **kw)
        dkv = fa.mh_flash_bwd_dkv(*args, segment_skip=True, bounds=sb, **kw)
        dkv_all = fa.mh_flash_bwd_dkv(*args, **kw)
        dq = fa.mh_flash_bwd_dq(*args, segment_skip=True, bounds=sb, **kw)
        dq_all = fa.mh_flash_bwd_dq(*args, **kw)
        torch.cuda.synchronize()
        e_fused = _hold_bwd(fused, want, dtype, f"fused {tag}")[0]
        e_dkv = _hold_bwd(dkv, want[1:], dtype, f"dkv {tag}")[0]
        e_dq = _hold_bwd((dq,), want[:1], dtype, f"dq {tag}")[0]
        skip_same = (fwd_same and torch.equal(fused[1], fused_all[1])
                     and torch.equal(fused[2], fused_all[2])
                     and _rel_err(fused[0], fused_all[0]) <= BWD_TOL[dtype]
                     and torch.equal(dkv[0], dkv_all[0]) and torch.equal(dkv[1], dkv_all[1])
                     and torch.equal(dq, dq_all))
        # a distinct copy of one array as the kv ids: the one-array call's bits
        copy = dict(kw, kv_segment_ids=q_ids.clone(), segment_skip=True)
        one = dict(kw, kv_segment_ids=None, segment_skip=True)
        o1, lse1 = fa.mh_flash_forward(q, k, v, q_ids, None, **one)
        args1 = (q, k, v, do, lse1, (o1.float() * do.float()).sum(-1), q_ids, None)
        same_copy = all(torch.equal(a, b) for a, b in (
            *zip(fa.mh_flash_forward(q, k, v, q_ids, None, **copy), (o1, lse1)),
            *zip(fa.mh_flash_bwd_dkv(*args1, **copy), fa.mh_flash_bwd_dkv(*args1, **one)),
            (fa.mh_flash_bwd_dq(*args1, **copy), fa.mh_flash_bwd_dq(*args1, **one))))
        print(f"separate ids {tag}: q rows that see none of the block "
              f"{1 - sees.float().mean().item():.4f}; fwd max|do| {err_f:.3e} (rtol, atol "
              f"{TOL[dtype]['o']}); max|d|/max|g| against plain: fused {e_fused:.2e}, dkv "
              f"{e_dkv:.2e}, dq {e_dq:.2e} (tolerance {BWD_TOL[dtype]}); skipping on == off "
              f"bit for bit (the fused dq within tolerance): {skip_same}; a copy of the "
              f"ids as kv ids == the one array bit for bit: {same_copy}")
        check(skip_same, f"skipping on differs from off at {tag}")
        check(same_copy, f"a copy of the ids differs from the one array at {tag}")
        if dtype == "bfloat16":
            worst["fwd"] = max(worst["fwd"], err_f)
            worst["bwd"] = max(worst["bwd"], max(_abs_err(g, w) for g, w in zip(fused, want)),
                               max(_abs_err(g, w) for g, w in zip((dq, *dkv), want)))
        del q, k, v, do, o, lse, o_all, lse_all, po, plse, want, fused, fused_all, dkv
        del dkv_all, dq, dq_all, o1, lse1, args, args1
        torch.cuda.empty_cache()
    # the kv pointer's cost: the training shape's forward with one ids array
    # and with a distinct copy of it as the kv ids (same bits, two pointers)
    B, T = TRAIN_SHAPE["B"], TRAIN_SHAPE["T"]
    q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", seed=990)
    seg = torch.from_numpy(next(bench_batches(B, T, 990))["segments"]).cuda().contiguous()
    sb, kv = fa.SegmentBounds(seg), seg.clone()
    kw = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=3, segment_skip=True)
    t_one = cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, rope, bounds=sb, **kw), 20)
    t_two = cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, rope, bounds=sb,
                                                kv_segment_ids=kv, **kw), 20)
    t_one2 = cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, rope, bounds=sb, **kw), 20)
    print(f"mh_flash_fwd B={B} T={T} dropout {TRAIN_DROPOUT}, RoPE, skipping: one ids "
          f"array {t_one:.4f} ms, then {t_one2:.4f} ms; a distinct copy as the kv ids "
          f"{t_two:.4f} ms")
    return worst


def _emulated_ring(q, k, v, seg, n, *, scale, body="flash", dropout_rate=0.0, seed=0):
    """A ring of n on one card, its members one after another: member i's
    ring body on its block of q with the blocks of k and v, the ids and the
    dropout seeds that each rotation would bring it (NCCL refuses two ranks
    on one card, so the P2P rotation is what this leaves out). Returns o
    on the whole sequence and the number of seg_block_bounds calls made
    outside RingSegments.prefill."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops import ring_attention as ra

    T = q.shape[1]
    Tl = T // n
    cut = lambda x, j: x[:, j * Tl:(j + 1) * Tl]
    outs = []
    for i in range(n):
        blocks = lambda r, i=i: (cut(k, (i - r) % n), cut(v, (i - r) % n))
        seeds = [ra.ring_seed(seed, i, r) for r in range(n)]
        q_ids = cut(seg, i)
        segs = ra.RingSegments(q_ids, [None] + [cut(seg, (i - r) % n) for r in range(1, n)])
        bq, bkv = ra.ring_blocks(Tl)
        if body == "flash":
            segs.prefill(q.dtype, "cuda", bq, bkv, q.shape[3])
            outs.append(ra.ring_body_flash(cut(q, i), blocks, n, segs.q_ids, segs,
                                           scale=scale, dropout_rate=dropout_rate,
                                           seeds=seeds, block_q=bq, block_kv=bkv))
        else:
            outs.append(ra.ring_body_plain(cut(q, i), blocks, n, segs.q_ids, segs.kv_ids,
                                           scale=scale, dropout_rate=dropout_rate,
                                           seeds=seeds))
    return torch.cat(outs, 1)


def _fwd_bwd(fn, q, k, v, g):
    import torch
    qs = [x.detach().requires_grad_() for x in (q, k, v)]
    o = fn(*qs)
    return (o, *torch.autograd.grad(o, qs, g))


def _kernel_ms(fn):
    """(device time of the flash kernels (#1-#5, their RoPE and dq
    epilogues), device time of every kernel) in one call of fn, in ms, by
    the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if "cuda" in str(getattr(e, "device_type", "")).lower()]
    return (sum(e.time_range.elapsed_us() for e in dev
                if any(s in e.name for s in _RING_KERNELS)) / 1e3,
            sum(e.time_range.elapsed_us() for e in dev) / 1e3)


def _sp_ring_bodies():
    """The flash ring body over N = 2 and 4 blocks of one sequence at
    omnibiote-small's heads (B 4, T 4096, H 8, D 128, bf16), against plain
    attention on the whole sequence and, under dropout, the plain body;
    each body's forward + backward times. Returns the launches of the ring
    path's runs (N = 4 on the fused backward, N = 2 on the split pair)."""
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops import ring_attention as ra
    from omnibiote_tpu_torch.ops.attention import attention, xla_attention

    B, T, H, D = 4, SP_CTX, SP_H, SP_D
    scale = 1.0 / math.sqrt(D)
    q, k, v, _, _ = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", seed=1000)
    seg = _long_segments("packed", B, T, 1000)
    g = torch.randn(B, T, H, D, generator=torch.Generator(device="cuda").manual_seed(1001),
                    device="cuda").bfloat16()
    ref = _fwd_bwd(lambda q, k, v: xla_attention(q, k, v, scale=scale, segment_ids=seg),
                   q.float(), k.float(), v.float(), g.float())
    counts = {"outside": 0, "prefill": 0}
    real_bounds, real_prefill = fa.seg_block_bounds, ra.RingSegments.prefill
    in_prefill = [False]

    def counting_bounds(*a, **kw):
        counts["prefill" if in_prefill[0] else "outside"] += 1
        return real_bounds(*a, **kw)

    def prefill(self, *a, **kw):
        in_prefill[0] = True
        try:
            return real_prefill(self, *a, **kw)
        finally:
            in_prefill[0] = False

    ring_path = dict.fromkeys(_kernels.LAUNCHES, 0)
    fa.seg_block_bounds, ra.RingSegments.prefill = counting_bounds, prefill
    try:
        for n in (4, 2):
            for split in (False, True):
                with _attention_switch(FUSED_SINGLE_KV_BWD=not split,
                                       FUSED_MULTIKV_BWD=not split):
                    # the ring path's run: counts at 0 just before, read after
                    _kernels.reset_launches()
                    counts["outside"] = counts["prefill"] = 0
                    got = _fwd_bwd(lambda q, k, v: _emulated_ring(q, k, v, seg, n, scale=scale),
                                   q, k, v, g)
                    torch.cuda.synchronize()
                    launches = {kk: vv for kk, vv in _kernels.LAUNCHES.items() if vv}
                    if (n == 4) != split:
                        for kk, vv in launches.items():
                            ring_path[kk] += vv
                errs = [_rel_err(a, b) for a, b in zip(got, ref)]
                kind = "split pair" if split else "fused"
                print(f"ring body N={n} (Tl={T // n}) over B={B} T={T} bf16, {kind} backward, "
                      f"dropout 0: max|d|/max|ref| against plain attention on the whole "
                      f"sequence (fp32): o {errs[0]:.2e}, dq {errs[1]:.2e}, dk {errs[2]:.2e}, "
                      f"dv {errs[3]:.2e} (tolerance 1e-2); launches {launches}; skip-bound "
                      f"computations (seg_block_bounds calls) in RingSegments.prefill "
                      f"{counts['prefill']} ({n} members), inside the rotations "
                      f"{counts['outside']}")
                check(max(errs) <= 1e-2, f"the N={n} ring body ({kind}) differs from "
                      f"plain attention on the whole sequence")
                check(counts["outside"] == 0, f"the N={n} ring computed skip bounds in "
                      f"its rotations")
                del got
            kw = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=4711)
            got = _fwd_bwd(lambda q, k, v: _emulated_ring(q, k, v, seg, n, **kw), q, k, v, g)
            want = _fwd_bwd(lambda q, k, v: _emulated_ring(q, k, v, seg, n, body="plain", **kw),
                            q, k, v, g)
            errs = [_rel_err(a, b) for a, b in zip(got, want)]
            print(f"ring body N={n} dropout {TRAIN_DROPOUT}: kernels against the plain body "
                  f"with the same Philox masks: max|d|/max|ref| o {errs[0]:.2e}, dq "
                  f"{errs[1]:.2e}, dk {errs[2]:.2e}, dv {errs[3]:.2e} (tolerance 1e-2)")
            check(max(errs) <= 1e-2, f"the N={n} flash ring body differs from the plain body "
                  f"under dropout")
            del got, want
    finally:
        fa.seg_block_bounds, ra.RingSegments.prefill = real_bounds, real_prefill
    del ref
    torch.cuda.empty_cache()

    # forward + backward times: one flash call on the whole sequence (the
    # dispatch's blocks), and the ring bodies of N = 1, 2 and 4
    runs = [("one flash call on the whole sequence",
             lambda q, k, v: attention(q, k, v, scale=scale, segment_ids=seg)),
            ("N=1", lambda q, k, v: ra.ring_attention(q, k, v, seg, scale=scale))]
    runs += [(f"N={n}", lambda q, k, v, n=n: _emulated_ring(q, k, v, seg, n, scale=scale))
             for n in (2, 4)]
    times = []
    for label, fn in runs + [("N=4, split pair", runs[-1][1])]:
        split = label.endswith("split pair")
        with _attention_switch(FUSED_SINGLE_KV_BWD=not split, FUSED_MULTIKV_BWD=not split):
            call = lambda: _fwd_bwd(fn, q, k, v, g)
            kernels, busy = _kernel_ms(call)
            times.append(f"{label} {cuda_ms(call, 5):.3f} ms ({kernels:.3f} in the flash "
                         f"kernels, {busy:.3f} of device work in all)")
    print(f"ring over blocks, forward + backward, B={B} T={T} bf16, {LONG_EOS} EOS a row, "
          f"no dropout, by CUDA events over 5 calls (a member after another for N > 1; "
          f"the profiler's kernel times of one call): " + "; ".join(times))
    return ring_path


def sp_phase(workdir):
    """Sequence parallelism on the card: #1-#5 with separate q and kv ids,
    the ring bodies at omnibiote-small's heads, the training CLI with
    --sharding sp at ctx 4096 on meshes (1,) and (1, 1) over NCCL, the sp
    Trainer against the plain one, and their tokens/s. Returns the ring
    path's launches (the CLI runs and the ring-body runs) and the worst
    bf16 errors of the kernel checks."""
    import json as _json
    import socket
    import torch
    import torch.distributed as dist
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.training import cli
    from omnibiote_tpu_torch.training.train import Trainer

    t_phase = time.time()
    worst = _sp_kernel_checks()
    ring_path = _sp_ring_bodies()
    torch.cuda.empty_cache()

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                 block_size=SP_CTX, attn_impl="ring")
    L = cfg.n_layer
    data = os.path.join(workdir, "data_sp")
    _write_shards(data, 600_000, seed=16)
    for shape in ((1,), (1, 1)):
        log = os.path.join(workdir, f"metrics_sp{len(shape)}.jsonl")
        argv = ["--base_dir", data, "--train_type", "mixed", "--n_layer", str(L),
                "--n_embd", "1024", "--n_head", "8", "--ctx_len", str(SP_CTX),
                "--dropout", str(TRAIN_DROPOUT), "--mini_batch_size", str(SP_MINI),
                "--batch_size", str(SP_MINI * SP_ACCUM), "--max_steps", str(SP_STEPS),
                "--save_dir", os.path.join(workdir, f"ckpt_sp{len(shape)}"),
                "--metrics_jsonl", log, "--log_every", "1", "--test_freq", "50000",
                "--sharding", "sp", "--mesh_shape", *map(str, shape)]
        print("train CLI: python -m omnibiote_tpu_torch.training.cli " + " ".join(argv))
        # main path: every count at 0 just before, read just after
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        trainer = cli.run(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        for k, v in launches.items():
            ring_path[k] += v
        with open(log) as f:
            recs = [_json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        probes = [k for r in recs for k in r if k.startswith("test_loss/")]
        # a ring of one: the block is the whole row (multi-kv above 1024)
        bwd = "mh_flash_bwd_mk" if SP_CTX > 1024 else "mh_flash_bwd"
        want = {"mh_flash_fwd": SP_STEPS * L * SP_ACCUM + len(probes) * L,
                bwd: SP_STEPS * L * SP_ACCUM}
        mesh = trainer.mesh
        print(f"train CLI sp {shape} at ctx {SP_CTX}: mesh {tuple(mesh.shape)} "
              f"{mesh.mesh_dim_names}, ring of {trainer.plan.ring.size}, backend "
              f"{dist.get_backend()}; {SP_STEPS} steps in {wall:.2f} s, losses "
              f"{[round(x, 4) for x in losses]}, {len(probes)} validation probes; launches "
              f"{launches} (want {want})")
        check(trainer.plan.ring is not None and trainer.model_cfg.attn_impl == "ring",
              "the sp CLI did not build a ring")
        check(len(losses) == SP_STEPS and all(math.isfinite(x) for x in losses),
              f"sp CLI losses {losses}")
        check(len(probes) > 0, "the sp CLI ran no validation probe")
        check(launches == want, f"sp CLI launches {launches}, want {want}")
        trainer.close()
        del trainer
        torch.cuda.empty_cache()

    # the sp Trainer (a ring of one) against the plain Trainer at dropout 0
    cfg0 = cfg.replace(dropout=0.0)
    tc = TrainConfig(batch_size=SP_MINI * SP_ACCUM, mini_batch_size=SP_MINI, ctx_len=SP_CTX,
                     token_budget=float(SP_MINI * SP_ACCUM * SP_CTX * 10000), seed=0)
    losses = {}
    for label, c, t in (("sp", cfg0, tc.replace(sharding="sp")),
                        ("plain", cfg0.replace(attn_impl="flash"), tc)):
        with Trainer(c, t, batch_iter=bench_batches(tc.batch_size, SP_CTX, 21, LONG_EOS)) as tr:
            losses[label] = [float(tr.train_step_once()["loss"]) for _ in range(SP_STEPS)]
        torch.cuda.empty_cache()
    dloss = max(abs(a - b) for a, b in zip(losses["sp"], losses["plain"]))
    print(f"sp Trainer (ring of 1) against the plain Trainer, dropout 0, {SP_STEPS} steps: "
          f"losses {[round(x, 6) for x in losses['sp']]} vs "
          f"{[round(x, 6) for x in losses['plain']]}, max |dloss| {dloss:.3e} (limit "
          f"{TRAIN_LOSS_ATOL})")
    check(dloss <= TRAIN_LOSS_ATOL, "the sp Trainer differs from the plain Trainer")

    tps_plain = _throughput(cfg.replace(attn_impl="flash"), tc, LONG_EOS, 5, f"ctx {SP_CTX}, "
                            "plain Trainer")
    tps_sp = _throughput(cfg, tc.replace(sharding="sp"), LONG_EOS, 5,
                         f"ctx {SP_CTX}, sp Trainer (ring of 1)")
    print(f"sp Trainer tokens/s {tps_sp:.1f} against plain {tps_plain:.1f}: "
          f"{tps_sp / tps_plain:.4f}")
    dist.destroy_process_group()
    print(f"sequence-parallel phase: {time.time() - t_phase:.1f} s; ring path launches "
          f"{ {k: v for k, v in ring_path.items() if v} }")
    return ring_path, worst


# ---------------------------------------------------------------------------
# 17. the pipeline at a stage axis of one
# ---------------------------------------------------------------------------

PP_RUNS = (("pp", (1,)), ("pp", (1, 1)), ("fsdp+pp", (1, 1)))
PP_STEPS = 3


def _pp_grads(model, cfg, tokens, segments, seeds, pipeline):
    """One step's loss (Σ over the slots) and fp32 gradients, divided by the
    slot count, of the compute copy of `model`: through the GPipe schedule
    at a stage axis of one (the gradients summed in the copy's `.grad`),
    or as the plain step takes them (each slot's `mlm_loss` gradients
    added in fp32)."""
    import torch
    from omnibiote_tpu_torch.parallel.pipeline import Stage, pipeline_step
    from omnibiote_tpu_torch.training.mlm import mlm_loss
    from omnibiote_tpu_torch.training.train import _compute_copy

    A = tokens.shape[0]
    params_c = _compute_copy(dict(model.named_parameters()), cfg)
    if pipeline:
        loss, _, _ = pipeline_step(model, Stage(None, 0, 1), params_c, tokens, segments,
                                   [1.0] * A, seeds)
        grads = {n: p.grad.float() / A for n, p in params_c.items()}
    else:
        loss = torch.zeros((), device=tokens.device)
        grads = {n: torch.zeros(p.shape, device=p.device) for n, p in params_c.items()}
        for i in range(A):
            li, _ = mlm_loss(model, tokens[i], segments[i], seeds[i], params=params_c)
            for n, g in zip(params_c, torch.autograd.grad(li, list(params_c.values()))):
                grads[n] += g.float()
            loss = loss + li.detach()
        grads = {n: g / A for n, g in grads.items()}
    return float(loss) / A, grads


def _stage_split(model, cfg, tok, seg, seed, n_stages):
    """One micro-batch through the stage functions of S = n_stages stages in
    turn, each handing its output to the next as a new leaf (what P2P hands
    over), and back: (loss, ln_f of the final hidden states, gradients)."""
    import torch
    from omnibiote_tpu_torch.ops.flash_attention import SegmentBounds
    from omnibiote_tpu_torch.parallel.pipeline import (embed, micro_draws, readout,
                                                       run_layers)
    from omnibiote_tpu_torch.models.omnibiota import _layer_norm
    from omnibiote_tpu_torch.training.mlm import _default_capacity_frac, apply_mlm_mask
    from omnibiote_tpu_torch.training.train import _compute_copy

    L = cfg.n_layer
    params_c = _compute_copy(dict(model.named_parameters()), cfg)
    mask, emb_seed, layer_seeds = micro_draws(model, tok, seed, mask_prob=0.15,
                                              deterministic=False)
    x = embed(model, params_c, apply_mlm_mask(tok, mask), emb_seed)
    seg = seg.to(torch.int32)
    kept = []
    for s in range(n_stages):
        x_in = x if s == 0 else x.detach().requires_grad_()
        layers = range(s * L // n_stages, (s + 1) * L // n_stages)
        x = run_layers(model, params_c, layers, x_in, seg, SegmentBounds(seg), layer_seeds)
        kept.append((x_in, x))
    final = x.detach().requires_grad_()
    nll_sum, count = readout(model, params_c, final, tok, mask, _default_capacity_frac(0.15))
    loss = nll_sum / count.clamp_min(1)
    loss.backward()
    emb = _layer_norm(final.detach(), params_c["transformer.ln_f.weight"])
    g = final.grad
    for s in reversed(range(n_stages)):
        x_in, h = kept[s]
        torch.autograd.backward(h, g)
        g = x_in.grad if s > 0 else None
    return loss.detach(), emb, {n: p.grad for n, p in params_c.items()}


def pp_phase(workdir):
    """The pipeline on the card over a one-rank NCCL group: the training CLI
    with --sharding pp / fsdp+pp on meshes (1,), (1, 1) at omnibiote-small
    full width, the pp Trainer against the plain one, the stage split at S
    = 2 and 4 against the whole model, and tokens/s and peak memory.
    Returns the launches of the pp CLI runs and of the pp Trainer's run on
    the split pair."""
    import json as _json
    import socket
    import torch
    import torch.distributed as dist
    from torch.func import functional_call
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.models.omnibiota import init_params
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.training import cli
    from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
    from omnibiote_tpu_torch.training.mlm import (apply_mlm_mask, make_mlm_mask, mlm_loss,
                                                  split_seed)
    from omnibiote_tpu_torch.training.train import Trainer, _compute_copy, slot_seed

    t_phase = time.time()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    mini, accum, ctx = 16, 2, 1024
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT)
    L = cfg.n_layer
    tc = TrainConfig(batch_size=mini * accum, mini_batch_size=mini, ctx_len=ctx,
                     token_budget=float(mini * accum * ctx * 10000), seed=0)

    # -- (a) the training CLI: the pipeline's main path -------------------
    data = os.path.join(workdir, "data_pp")
    _write_shards(data, 600_000, seed=17)
    main = dict.fromkeys(_kernels.LAUNCHES, 0)
    for mode, shape in PP_RUNS:
        tag = f"{mode.replace('+', '_')}{len(shape)}"
        log = os.path.join(workdir, f"metrics_{tag}.jsonl")
        save = os.path.join(workdir, f"ckpt_{tag}")
        argv = ["--base_dir", data, "--train_type", "mixed", "--n_layer", str(L),
                "--n_embd", "1024", "--n_head", "8", "--ctx_len", str(ctx),
                "--dropout", str(TRAIN_DROPOUT), "--mini_batch_size", str(mini),
                "--batch_size", str(mini * accum), "--save_dir", save,
                "--metrics_jsonl", log, "--log_every", "1", "--test_freq", "50000",
                "--sharding", mode, "--mesh_shape", *map(str, shape)]
        print("train CLI: python -m omnibiote_tpu_torch.training.cli "
              + " ".join(argv + ["--max_steps", str(PP_STEPS)]))
        # main path: every count at 0 just before, read just after
        _kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        trainer = cli.run(argv + ["--max_steps", str(PP_STEPS)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        stage = trainer.plan.stage
        check(stage is not None and stage.size == 1
              and trainer.mesh.mesh_dim_names == (("stage",) if len(shape) == 1
                                                  else ("data", "stage")),
              f"the {mode} CLI built no stage axis: {trainer.mesh}")
        files = sorted(os.listdir(os.path.join(save, "omnibiota")))
        t0 = time.time()
        reloaded, _ = load_model_checkpoint(os.path.join(save, "omnibiota"))
        same = all(torch.equal(p, trainer.params[n]) for n, p in reloaded.named_parameters())
        del trainer, reloaded
        torch.cuda.empty_cache()
        t_reload = time.time() - t0
        t0 = time.time()
        resumed = cli.run(argv + ["--max_steps", "1", "--resume_from", "-1"])
        torch.cuda.synchronize()
        t_resume = time.time() - t0
        launches = {k: v for k, v in _kernels.LAUNCHES.items() if v}
        for k, v in launches.items():
            main[k] += v
        with open(log) as f:
            recs = [_json.loads(line) for line in f]
        losses = [r["loss"] for r in recs if "loss" in r]
        probes = [k for r in recs for k in r if k.startswith("test_loss/")]
        want = {"mh_flash_fwd": (PP_STEPS + 1) * L * accum + len(probes) * L,
                "mh_flash_bwd": (PP_STEPS + 1) * L * accum}
        print(f"train CLI {mode} {shape}: {PP_STEPS} steps in {wall:.2f} s, checkpoint "
              f"{files} reloaded equal to the trainer's parameters: {same} "
              f"({t_reload:.2f} s); 1 step resumed from it (step {resumed.step}, "
              f"{t_resume:.2f} s); losses "
              f"{[round(x, 4) for x in losses]}, {len(probes)} validation probes; "
              f"launches {launches} (want {want})")
        check(same, f"the {mode} {shape} checkpoint does not reload")
        check(resumed.step == PP_STEPS + 1, f"resumed run ended at step {resumed.step}")
        check(len(losses) == PP_STEPS + 1 and all(math.isfinite(x) for x in losses),
              f"{mode} CLI losses {losses}")
        check(len(probes) > 0, f"the {mode} CLI ran no validation probe")
        check(launches == want, f"{mode} CLI launches {launches}, want {want}")
        del resumed
        torch.cuda.empty_cache()

    print(f"pipeline phase (a): {time.time() - t_phase:.1f} s")
    t_part = time.time()

    # -- (b) the pp Trainer against the plain Trainer ---------------------
    gen = bench_batches(mini * accum, ctx, seed=21)
    batches = [next(gen) for _ in range(PP_STEPS)]
    tc0 = tc.replace(mesh_shape=(1,))
    losses, split = {}, {}
    with _attention_switch(FUSED_SINGLE_KV_BWD=False):
        for label, t in (("plain", tc), ("pp (1,)", tc0.replace(sharding="pp"))):
            with Trainer(cfg.replace(dropout=0.0), t, batch_iter=iter(batches)) as tr:
                _kernels.reset_launches()
                losses[label] = [float(tr.train_step_once()["loss"])
                                 for _ in range(PP_STEPS)]
                torch.cuda.synchronize()
                split[label] = {k: v for k, v in _kernels.LAUNCHES.items() if v}
            torch.cuda.empty_cache()
    dloss = max(abs(a - b) for a, b in zip(losses["pp (1,)"], losses["plain"]))
    want = {"mh_flash_fwd": PP_STEPS * L * accum, "mh_flash_bwd_dkv": PP_STEPS * L * accum,
            "mh_flash_bwd_dq": PP_STEPS * L * accum}
    print(f"pp Trainer (1,) against the plain Trainer, dropout 0, split pair, {PP_STEPS} "
          f"steps: losses {[round(x, 6) for x in losses['pp (1,)']]} vs "
          f"{[round(x, 6) for x in losses['plain']]}, max |dloss| {dloss:.3e} (limit "
          f"{TRAIN_LOSS_ATOL}); pp launches {split['pp (1,)']} (want {want})")
    check(dloss <= TRAIN_LOSS_ATOL, "the pp Trainer differs from the plain Trainer")
    check(split["pp (1,)"] == want == split["plain"], f"pp split-pair launches {split}")

    model = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    tokens = torch.from_numpy(batches[0]["tokens"]).cuda().view(accum, mini, ctx)
    segments = torch.from_numpy(batches[0]["segments"]).cuda().view(accum, mini, ctx)
    seeds = [slot_seed(7, 0, i) for i in range(accum)]
    loss_pp, g_pp = _pp_grads(model, cfg, tokens, segments, seeds, pipeline=True)
    loss_pl, g_pl = _pp_grads(model, cfg, tokens, segments, seeds, pipeline=False)
    norm = lambda g: math.sqrt(sum(float(x.double().square().sum()) for x in g.values()))
    gn_pp, gn_pl = norm(g_pp), norm(g_pl)
    cos = _worst_cos(g_pp, g_pl)
    print(f"pp step (1,) against the plain step, dropout {TRAIN_DROPOUT}, A = {accum}: loss "
          f"{loss_pp:.6f} vs {loss_pl:.6f} (|d| {abs(loss_pp - loss_pl):.2e}, limit "
          f"{TRAIN_LOSS_ATOL}); worst gradient cosine {cos:.6f} over {len(g_pp)} tensors "
          f"(limit {TRAIN_GRAD_COS}); gradient norm {gn_pp:.6f} vs {gn_pl:.6f} (relative "
          f"{abs(gn_pp - gn_pl) / gn_pl:.2e}, limit {TRAIN_GNORM_RTOL})")
    check(abs(loss_pp - loss_pl) <= TRAIN_LOSS_ATOL and cos >= TRAIN_GRAD_COS
          and abs(gn_pp - gn_pl) <= TRAIN_GNORM_RTOL * gn_pl,
          "the pp step differs from the plain step under dropout")
    del g_pp, g_pl

    print(f"pipeline phase (b): {time.time() - t_part:.1f} s")
    t_part = time.time()

    # -- (c) the stage split at S = 2 and 4 against the whole model --------
    tok, seg = tokens[0], segments[0]
    for fused in (False, True):
        kind = "fused" if fused else "split pair"
        with _attention_switch(FUSED_SINGLE_KV_BWD=fused):
            params_c = _compute_copy(dict(model.named_parameters()), cfg)
            whole, _ = mlm_loss(model, tok, seg, 4321, params=params_c)
            g_whole = dict(zip(params_c, torch.autograd.grad(whole, list(params_c.values()))))
            mask_seed, drop_seed = split_seed(4321)
            gmask = torch.Generator(device="cuda").manual_seed(mask_seed & 0x7FFFFFFFFFFFFFFF)
            ids = apply_mlm_mask(tok, make_mlm_mask(gmask, tok, 0.15))
            with torch.no_grad():
                emb_whole = functional_call(model, params_c, (ids, seg), dict(
                    deterministic=False, rng=drop_seed, return_embeddings=True))
            del params_c
            for n_stages in (2, 4):
                loss, emb, grads = _stage_split(model, cfg, tok, seg, 4321, n_stages)
                differ = _grads_equal(g_whole, grads)
                worst = max(_rel_err(grads[n], g_whole[n]) for n in grads)
                cos = _worst_cos(grads, g_whole)
                print(f"stage split S = {n_stages} ({kind}, dropout {TRAIN_DROPOUT}, mini "
                      f"{mini}, T {ctx}) against the whole model: loss bit for bit "
                      f"{torch.equal(loss, whole.detach())}, final hidden states bit for "
                      f"bit {torch.equal(emb, emb_whole)}; gradients differing in any bit "
                      f"{len(differ)} of {len(grads)}, worst max|d|/max|g| {worst:.2e}, "
                      f"worst cosine {cos:.9f}")
                check(torch.equal(loss, whole.detach()) and torch.equal(emb, emb_whole),
                      f"the stage split S = {n_stages} ({kind}) changes the forward")
                if fused:
                    check(worst <= BWD_TOL["bfloat16"] and cos >= TRAIN_GRAD_COS,
                          f"the stage split S = {n_stages} (fused) gradients")
                else:
                    check(not differ, f"the stage split S = {n_stages} (split pair) "
                                      f"gradients differ in {differ[:4]}")
                del grads, emb
            del g_whole, emb_whole
    del model
    torch.cuda.empty_cache()

    print(f"pipeline phase (c): {time.time() - t_part:.1f} s")
    t_part = time.time()

    # -- (d) tokens/s and peak memory, pp (1,) against plain ---------------
    rates = {}
    for cf in (0, 1):
        c = cfg.replace(checkpoint_freq=cf)
        rates[f"plain, checkpoint_freq {cf}"] = _throughput(
            c, tc, 3, 5, f"ctx {ctx}, plain Trainer, checkpoint_freq {cf}")
        rates[f"pp (1,), checkpoint_freq {cf}"] = _throughput(
            c, tc0.replace(sharding="pp"), 3, 5, f"ctx {ctx}, pp Trainer (1,), "
            f"checkpoint_freq {cf}", record=cf == 0)
        print(f"pp Trainer (1,) tokens/s at checkpoint_freq {cf}: "
              f"{rates[f'pp (1,), checkpoint_freq {cf}']:.1f} against plain "
              f"{rates[f'plain, checkpoint_freq {cf}']:.1f}: "
              f"{rates[f'pp (1,), checkpoint_freq {cf}'] / rates[f'plain, checkpoint_freq {cf}']:.4f}")
    print(f"pipeline phase (d): {time.time() - t_part:.1f} s")
    dist.destroy_process_group()
    print(f"pipeline phase: {time.time() - t_phase:.1f} s; pp main path launches "
          f"{ {k: v for k, v in main.items() if v} }; pp Trainer split-pair launches "
          f"{split['pp (1,)']}")
    return main, split["pp (1,)"]

# ---------------------------------------------------------------------------
# 18. the pod planner against the card's measured peaks
# ---------------------------------------------------------------------------

# The planner's memory_bytes.total against the measured peak: measured /
# planned within these bounds for every anchor. The card's readings lie in
# 1.0000-1.0055 (PERF.md, PR 19); a block's fp32 LayerNorm tensor left out
# of the plan moves omnibiote-small's ratio by about 5 %.
POD_RATIO = (0.97, 1.03)
POD_STEPS = 2
# ROADMAP item 11's third row: 16 layers, d 2048, 16 heads of 128, ctx 1024,
# 8 x 2, bf16 moments and gradients, 'full' remat. No earlier phase trains
# it: the planner's held-out anchor.
HELD_OUT = dict(n_layer=16, n_embd=2048, n_head=16)


def _pod_anchors():
    """(label, model config, train config, EOS a row) of every anchor."""
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import OmniBioTAConfig, TrainConfig

    def small(T=1024, **kw):
        return preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                      block_size=T, **kw)

    def tc(m, a, T, **kw):
        return TrainConfig(batch_size=m * a, mini_batch_size=m, ctx_len=T,
                           token_budget=float(m * a * T * 10000), seed=0, **kw)

    return (
        ("omnibiote-small ctx 1024 16 x 2, remat off", small(), tc(16, 2, 1024), 3),
        ("omnibiote-small ctx 1024 16 x 2, remat full", small(checkpoint_freq=1),
         tc(16, 2, 1024), 3),
        ("omnibiote-small ctx 1024 16 x 2, remat dots",
         small(checkpoint_freq=1, remat_policy="dots"), tc(16, 2, 1024), 3),
        ("omnibiote-small ctx 1024 16 x 2, remat off, fused CE", small(fused_ce=True),
         tc(16, 2, 1024), 3),
        ("omnibiote-small ctx 4096 4 x 2, remat off", small(4096), tc(4, 2, 4096), LONG_EOS),
        ("omnibiote-small ctx 1024 16 x 2, pp (1,)", small(),
         tc(16, 2, 1024, sharding="pp", mesh_shape=(1,)), 3),
        ("held out: 16 layers d 2048, ctx 1024 8 x 2, bf16 moments and grads, remat full",
         OmniBioTAConfig(**HELD_OUT, vocab_size=65536, block_size=1024, dropout=TRAIN_DROPOUT,
                         checkpoint_freq=1),
         tc(8, 2, 1024, moment_dtype="bfloat16", grad_dtype="bfloat16"), 3),
    )


def _peak_run(cfg, tc, n_eos, steps=POD_STEPS):
    """Peak allocated memory of `steps` Trainer steps above what was
    allocated before the Trainer, and the finite losses."""
    import torch
    from omnibiote_tpu_torch.training.train import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with Trainer(cfg, tc, batch_iter=bench_batches(tc.batch_size, tc.ctx_len, 31, n_eos),
                 prefetch=2) as tr:
        losses = [float(tr.train_step_once()["loss"]) for _ in range(steps)]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.empty_cache()
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    return peak, base, losses


def _hold_held_out_attention(cfg, tc, n_eos):
    """#1 and #2 as the held-out model's training step calls them (its
    micro-batch's segment ids with segment skipping, dropout, 16 heads of
    128) against their plain versions at TOL and BWD_TOL. Returns max |do|
    and the backward's max |d|."""
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops.flash_attention import (
        KERNEL_KV_TILE, SegmentBounds, mh_flash_backward, mh_flash_backward_plain,
        mh_flash_forward, mh_flash_forward_plain)

    B, T, H = tc.mini_batch_size, tc.ctx_len, cfg.n_head
    D = cfg.n_embd // H
    q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 57)
    seg = torch.from_numpy(
        next(bench_batches(tc.batch_size, T, 31, n_eos))["segments"][:B]).cuda()
    bounds = SegmentBounds(seg)
    gen = torch.Generator(device="cuda").manual_seed(58)
    do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=cfg.dropout, seed=0x5EED19)
    before = dict(_kernels.LAUNCHES)
    o, lse = mh_flash_forward(q, k, v, seg, rope, **kw, segment_skip=True, bounds=bounds)
    di = (o.float() * do.float()).sum(-1)
    got = mh_flash_backward(q, k, v, do, lse, di, seg, rope, **kw, segment_skip=True,
                            bounds=bounds)
    torch.cuda.synchronize()
    ran = {n: c - before[n] for n, c in _kernels.LAUNCHES.items() if c != before[n]}
    check(ran == {"mh_flash_fwd": 1, "mh_flash_bwd": 1},
          f"the held-out shape's calls launched {ran}, want #1 and #2 once each")
    shape = f"the held-out shape B={B} T={T} H={H} D={D} dropout {cfg.dropout}"
    err_f = _hold_fwd((o, lse), mh_flash_forward_plain(
        q, k, v, seg, rope, **kw, block_kv=KERNEL_KV_TILE[torch.bfloat16]), "bfloat16", shape)
    rel_b, err_b = _hold_bwd(got, mh_flash_backward_plain(q, k, v, do, lse, di, seg, rope, **kw),
                             "bfloat16", shape)
    print(f"kernels vs plain at {shape}, bf16, the held-out run's segment ids: fwd max|do| "
          f"{err_f:.3e} (rtol, atol {TOL['bfloat16']['o']}), bwd max|d|/max|g| {rel_b:.2e} "
          f"(tolerance {BWD_TOL['bfloat16']}), max|d| {err_b:.3e}")
    del q, k, v, do, o, lse, di, got
    torch.cuda.empty_cache()
    return {"fwd": err_f, "bwd": err_b}


def pod_plan_phase():
    """tools/gpu_pod_plan.py's memory_bytes.total against the peak the
    card allocates, for each anchor: the peaks phases 13 and 17 recorded
    for it (MEASURED_PEAKS), else POD_STEPS steps here; the held-out model
    always here (its #1 and #2 launches counted), then #1 and #2 held
    against their plain versions at its shape. Then the planner's 2 x 8
    fsdp+tp plan of the held-out model (an estimate, not held). Returns the
    held-out run's launches and the two kernels' errors at its shape."""
    import torch
    import torch.distributed as dist
    from omnibiote_tpu_torch.ops import _kernels

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import gpu_pod_plan

    t_phase = time.time()
    capacity = torch.cuda.get_device_properties(0).total_memory
    rows, held_out, held_err = [], {}, {}
    own_group = False
    for label, cfg, tc, n_eos in _pod_anchors():
        key = _peak_key(cfg, tc)
        is_held_out = cfg.n_embd == HELD_OUT["n_embd"]
        if key in MEASURED_PEAKS and not is_held_out:
            peak, base, source = MEASURED_PEAKS[key]
        else:
            if tc.sharding == "pp" and not dist.is_initialized():
                import socket
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", 0))
                    port = sock.getsockname()[1]
                dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                        rank=0, world_size=1)
                own_group = True
            if is_held_out:
                _kernels.reset_launches()
            peak, base, losses = _peak_run(cfg, tc, n_eos)
            source = f"{POD_STEPS} steps here, losses {[round(x, 4) for x in losses]}"
            if is_held_out:
                held_out = {k: v for k, v in _kernels.LAUNCHES.items() if v}
                L, A = cfg.n_layer, tc.batch_size // tc.mini_batch_size
                want = {"mh_flash_fwd": POD_STEPS * A * L * 2, "mh_flash_bwd": POD_STEPS * A * L}
                print(f"held-out model: {POD_STEPS} steps, launches {held_out} (want {want}: "
                      f"#1 twice a layer under remat, #2 once)")
                check(held_out == want, f"held-out launches {held_out}, want {want}")
                held_err = _hold_held_out_attention(cfg, tc, n_eos)
        mesh = tc.mesh_shape
        plan = gpu_pod_plan.plan(
            cfg, chips=1, sharding=tc.sharding, mesh=mesh, mini=tc.mini_batch_size,
            accum=tc.batch_size // tc.mini_batch_size, ctx=tc.ctx_len,
            moment_dtype=tc.moment_dtype, grad_dtype=tc.grad_dtype,
            remat=cfg.checkpoint_freq, remat_policy=cfg.remat_policy,
            fused_ce=cfg.fused_ce, capacity=capacity)
        mem = plan["memory_bytes"]
        ratio = peak / mem["total"]
        rows.append(dict(label=label, measured_gib=peak / 2**30,
                         planned_gib=mem["total"] / 2**30, ratio=ratio,
                         peak_at=mem["peak_at"], base_gib=base / 2**30, source=source))
        print(f"pod plan anchor {label}: measured {peak / 2**30:.3f} GiB (above "
              f"{base / 2**30:.3f} GiB allocated before; {source}), planned "
              f"{mem['total'] / 2**30:.3f} GiB at {mem['peak_at']} (phases "
              f"{ {k: round(v / 2**30, 3) for k, v in mem['phases'].items()} }), "
              f"ratio {ratio:.4f} (bounds {POD_RATIO})")
        check(POD_RATIO[0] <= ratio <= POD_RATIO[1],
              f"the planner's memory for '{label}': measured/planned {ratio:.4f}")
    if own_group:
        dist.destroy_process_group()

    cfg = _pod_anchors()[-1][1]
    pod = gpu_pod_plan.plan(cfg, chips=16, sharding="fsdp+tp", mesh=(2, 8), mini=8, accum=2,
                            ctx=1024, moment_dtype="bfloat16", grad_dtype="bfloat16",
                            remat=1, capacity=capacity)
    check(pod["projection"]["estimate"] and pod["projection"]["step_s"] > 0,
          "the 2 x 8 plan's projection")
    print("pod plan, held-out model on 2 nodes x 8 H100 (fsdp+tp, mesh (2, 8); an estimate, "
          "not held): " + json.dumps({k: pod[k] for k in (
              "parallel", "collectives_bytes", "links", "times_s", "projection")}
              | {"memory_gib": pod["memory_bytes"]["total"] / 2**30,
                 "peak_at": pod["memory_bytes"]["peak_at"]}))
    print("pod plan anchors: " + json.dumps(rows))
    print(f"pod plan phase: {time.time() - t_phase:.1f} s")
    return held_out, held_err


# ---------------------------------------------------------------------------
# 19. head dim 256, and one head at any head dim up to 256
# ---------------------------------------------------------------------------

# omnibiote-small's width with 4 heads of 256 (`--n_head 4`): the same 168 M
# parameters and attention FLOPs a token as its 8 heads of 128.
WIDE_HEADS, WIDE_D = 4, 256
# (layout, T, EOS a row): dense rows, bench.py's packed rows, PAD tails,
# bench_longctx.py's packed rows
WIDE_LAYOUTS = (("dense", 1024, 0), ("packed", 1024, 3), ("padded", 1024, 0),
                ("packed", 2048, LONG_EOS))


def _wide_ids(layout, B, T, n_eos, seed):
    import torch
    if layout == "packed":
        return torch.from_numpy(next(bench_batches(B, T, seed, n_eos))["segments"]).cuda()
    return _segments(layout, B, T, torch.Generator(device="cuda").manual_seed(seed))


def _sdpa(qh, kh, vh, **kw):
    """(ms of the default SDPA call, the backends that take it alone, each
    with its time): which one the default runs at this shape."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with torch.no_grad():
        default = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw), 10)
        alone = {}
        for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            try:
                with sdpa_kernel(backend):
                    alone[backend.name] = cuda_ms(
                        lambda: F.scaled_dot_product_attention(qh, kh, vh, **kw), 10)
            except RuntimeError:
                pass
    return default, alone


def _wide_kernel_checks(H=WIDE_HEADS, D=WIDE_D, layouts=WIDE_LAYOUTS, seed=1900,
                        lse_shape=(2, 1024)):
    """#1-#5 at H heads of D, bf16 and fp32, dropout 0 and 0.1, over the
    (layout, T, EOS a row) `layouts` (B 2 at T 1024, else 1): each against
    its plain version, with bounds against the full walk (the same bits;
    the fused dq within its tolerance), the tiles walked against the
    bounds' count, the split pair the same bits at a second launch, fused
    against split; then flash_attention_lse with separate q and kv ids
    through autograd at lse_shape (B, T). Returns the worst bf16 max |do|
    and max |d| of the forward and backwards."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(D)
    worst = {"fwd": 0.0, "bwd": 0.0}
    i = 0
    for dtype in ("bfloat16", "float32"):
        for layout, T, n_eos in layouts:
            for rate in (0.0, TRAIN_DROPOUT):
                B = 2 if T == 1024 else 1
                i += 1
                tdt = getattr(torch, dtype)
                tag = f"D={D} B={B} T={T} {dtype} {layout}{n_eos or ''} dropout {rate}"
                q, k, v, _, rope = _attn_inputs(B, T, H, D, tdt, "dense", seed=seed + i)
                seg = _wide_ids(layout, B, T, n_eos, seed + i)
                gen = torch.Generator(device="cuda").manual_seed(seed + 50 + i)
                do = torch.randn(B, T, H, D, generator=gen, device="cuda").to(tdt)
                kw = dict(scale=scale, dropout_rate=rate, seed=0x2560 + i)
                (tq, tkv), (bq, bkv), (kq, kkv), (dq_q, dq_kv) = (
                    fa.kernel_tiles(kind, tdt, D) for kind in ("fwd", "fused", "dkv", "dq"))
                sb = None if seg is None else fa.SegmentBounds(seg)
                walk = lambda a, b: (H * B * (T // a) * (T // b), None) if sb is None else (
                    H * int((sb.get(a, b)[1] - sb.get(a, b)[0] + 1).sum()), sb.get(a, b))
                (n_f, kv_b), (n_q, q_b), (n_kv, dkv_b), (n_dq, dq_b) = (
                    walk(tq, tkv), walk(bkv, bq), walk(kkv, kq), walk(dq_q, dq_kv))

                o, lse = _walked(lambda c: fa.mh_flash_forward_kernel(
                    q, k, v, seg, rope, kv_bounds=kv_b, tile_count=c, **kw), n_f,
                    f"forward {tag}")
                o_all, lse_all = fa.mh_flash_forward_kernel(q, k, v, seg, rope, **kw)
                check(torch.equal(o, o_all) and torch.equal(lse, lse_all),
                      f"forward with bounds differs from the full walk at {tag}")
                # no atomics in the forward: a second launch gives the same bits
                o_again, lse_again = fa.mh_flash_forward_kernel(q, k, v, seg, rope,
                                                                kv_bounds=kv_b, **kw)
                check(torch.equal(o, o_again) and torch.equal(lse, lse_again),
                      f"a second forward launch differs from the first at {tag}")
                po, plse = fa.mh_flash_forward_plain(q, k, v, seg, rope, block_q=tq,
                                                     block_kv=tkv, segment_skip=True,
                                                     bounds=sb, **kw)
                err_f = _hold_fwd((o, lse), (po, plse), dtype, tag)
                di = (po.float() * do.float()).sum(-1)
                args = (q, k, v, do, plse, di, seg, rope)
                want = fa.mh_flash_backward_plain(*args, block_q=bq, block_kv=bkv,
                                                  segment_skip=True, bounds=sb, **kw)
                fused = _walked(lambda c: fa.mh_flash_backward_kernel(
                    *args, tile_bounds=q_b, tile_count=c, **kw), n_q, f"fused {tag}")
                fused_all = fa.mh_flash_backward_kernel(*args, **kw)
                dkv = _walked(lambda c: fa.mh_flash_bwd_dkv_kernel(
                    *args, tile_bounds=dkv_b, tile_count=c, **kw), n_kv, f"dkv {tag}")
                dkv_all = fa.mh_flash_bwd_dkv_kernel(*args, **kw)
                dkv_again = fa.mh_flash_bwd_dkv_kernel(*args, tile_bounds=dkv_b, **kw)
                dq = _walked(lambda c: fa.mh_flash_bwd_dq_kernel(
                    *args, tile_bounds=dq_b, tile_count=c, **kw), n_dq, f"dq {tag}")
                dq_all = fa.mh_flash_bwd_dq_kernel(*args, **kw)
                dq_again = fa.mh_flash_bwd_dq_kernel(*args, tile_bounds=dq_b, **kw)
                torch.cuda.synchronize()
                same = (torch.equal(fused[1], fused_all[1]) and torch.equal(fused[2], fused_all[2])
                        and _rel_err(fused[0], fused_all[0]) <= BWD_TOL[dtype]
                        and all(torch.equal(a, b) for a, b in (*zip(dkv, dkv_all),
                                                               *zip(dkv, dkv_again)))
                        and torch.equal(dq, dq_all) and torch.equal(dq, dq_again))
                e_fused, w_fused = _hold_bwd(fused, want, dtype, f"fused {tag}")
                e_split, w_split = _hold_bwd((dq, *dkv), want, dtype, f"split {tag}")
                e_fs = max(_rel_err(g, w) for g, w in zip(fused, (dq, *dkv)))
                print(f"wide kernels {tag}: tiles walked fwd {n_f}, fused {n_q}, dkv {n_kv}, "
                      f"dq {n_dq} (as their bounds give); fwd max|do| {err_f:.3e}, bounds on == "
                      f"off and a second launch the same bits; "
                      f"max|d|/max|g| vs plain: fused {e_fused:.2e}, split {e_split:.2e}, "
                      f"fused vs split {e_fs:.2e} (tolerance {BWD_TOL[dtype]}); bounds on == "
                      f"off and the split pair's second launch the same bits: {same}")
                check(same, f"skipping on differs from off, or a second launch from the "
                      f"first, at {tag}")
                check(e_fs <= BWD_TOL[dtype], f"fused and split disagree at {tag}")
                if dtype == "bfloat16":
                    worst["fwd"] = max(worst["fwd"], err_f)
                    worst["bwd"] = max(worst["bwd"], w_fused, w_split)
                del q, k, v, do, o, lse, o_all, lse_all, o_again, lse_again, po, plse, want
                del fused, fused_all
                del dkv, dkv_all, dkv_again, dq, dq_all, dq_again, args
                torch.cuda.empty_cache()

    # flash_attention_lse with separate q and kv ids (a ring rotation's
    # pair) and a random lse cotangent on the rows that see the block
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        (B, T), n = lse_shape, 2
        q0, k0, v0, _, _ = _attn_inputs(B, T, H, D, tdt, "dense", seed=seed + 90)
        q_ids, kv_ids = _sp_pair(B, T, n, seed + 90)
        sees = (q_ids[:, :, None] == kv_ids[:, None, :]).any(-1)
        gen = torch.Generator(device="cuda").manual_seed(seed + 91)
        do = (torch.randn(B, T, H, D, generator=gen, device="cuda") * sees[..., None, None]).to(tdt)
        dlse = torch.randn(B, T, H, generator=gen, device="cuda") * sees[..., None]

        def lse_grads():
            q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
            # blocks of half the row: the multi-kv backward, as the ring's
            o, lse = fa.flash_attention_lse(q, k, v, q_ids, None, scale=scale,
                                            dropout_rate=TRAIN_DROPOUT, seed=78,
                                            block_q=T // 2, block_kv=T // 2,
                                            kv_segment_ids=kv_ids)
            return (o, lse, *torch.autograd.grad((o, lse), (q, k, v), (do, dlse)))

        with _plain_attention():
            want = lse_grads()
        for fused in (True, False):
            with _attention_switch(FUSED_MULTIKV_BWD=fused):
                got = lse_grads()
            err_o = _abs_err(got[0][sees], want[0][sees])
            errs = [_rel_err(g, w) for g, w in zip(got[2:], want[2:])]
            print(f"flash_attention_lse D={D} {dtype}, separate q and kv ids, random dlse, "
                  f"{'fused' if fused else 'split'} backward vs plain: max|do| {err_o:.3e}, "
                  f"max|dlse| {(got[1] - want[1])[sees].abs().max().item():.2e}, max|d|/max|g| "
                  f"{max(errs):.2e} (tolerance {BWD_TOL[dtype]})")
            rt, at = TOL[dtype]["o"]
            check(torch.allclose(got[0][sees].float(), want[0][sees].float(), rtol=rt, atol=at)
                  and torch.allclose(got[1][sees], want[1][sees], rtol=1e-5, atol=1e-4)
                  and max(errs) <= BWD_TOL[dtype],
                  f"flash_attention_lse at D={D} {dtype}: kernels disagree with plain")
        del q0, k0, v0, do, dlse, want, got
    return worst


def _wide_padded_checks(dims=(96, 32)):
    """One head at each D of `dims` with RoPE: flash_attention forward and
    backward through the kernels of the next head dim they take on
    zero-padded inputs, against the plain versions at the caller's D, bf16
    and fp32, dropout 0 and 0.1; each call launches #1 and #2 once."""
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    for D in dims:
        for dtype in ("bfloat16", "float32"):
            for rate in (0.0, TRAIN_DROPOUT):
                B, T = 4, 1024
                tdt = getattr(torch, dtype)
                q0, k0, v0, _, rope = _attn_inputs(B, T, 1, D, tdt, "dense", seed=2000 + D)
                seg = _wide_ids("packed", B, T, 3, 2000 + D)
                gen = torch.Generator(device="cuda").manual_seed(2001 + D)
                do = torch.randn(B, T, 1, D, generator=gen, device="cuda").to(tdt)
                kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=rate, seed=0xD96 + D)

                def fwd_bwd():
                    q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
                    o = fa.flash_attention(q, k, v, seg, rope, block_q=512, block_kv=1024, **kw)
                    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))

                def plain_fwd_bwd():
                    # the plain versions at the caller's D, unpadded, on the
                    # kernel's kv tile (its order of rounding)
                    q, k, v = (x.clone().requires_grad_() for x in (q0, k0, v0))
                    with _plain_attention():
                        o = fa.MhFlashAttention.apply(
                            q, k, v, seg, rope[0][:T], rope[1][:T], kw["scale"], rate,
                            kw["seed"], 512, 1024, fa.kernel_kv_tile(tdt, fa.padded_head_dim(D)),
                            False, None, True)
                        return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))

                _kernels.reset_launches()
                got = fwd_bwd()
                torch.cuda.synchronize()
                check(_kernels.LAUNCHES == _counts(mh_flash_fwd=1, mh_flash_bwd=1),
                      f"one head at D={D}: launches {_kernels.LAUNCHES}")
                want = plain_fwd_bwd()
                check(_kernels.LAUNCHES == _counts(mh_flash_fwd=1, mh_flash_bwd=1),
                      "the plain run launched a kernel")
                rt, at = TOL[dtype]["o"]
                tag = f"one head D={D} (padded to {fa.padded_head_dim(D)}) {dtype} dropout {rate}"
                check(got[0].shape == q0.shape and torch.allclose(
                    got[0].float(), want[0].float(), rtol=rt, atol=at),
                    f"{tag}: forward disagrees with the plain version")
                rel, _ = _hold_bwd(got[1:], want[1:], dtype, tag)
                print(f"{tag}, RoPE, packed: max|do| {_abs_err(got[0], want[0]):.3e} (rtol {rt}, "
                      f"atol {at}), backward max|d|/max|g| {rel:.2e} (tolerance "
                      f"{BWD_TOL[dtype]}); launches {dict((n, c) for n, c in _kernels.LAUNCHES.items() if c)}")


def _wide_timings(H=WIDE_HEADS, D=WIDE_D):
    """Each kernel at H heads of D at its path's shape beside its plain
    version, its bound and SDPA, the forward's at the serving shape, the
    backwards at the training shapes. Returns the rows of the kernels line
    (launches left at None, the errors at these shapes)."""
    import torch
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops import int8_attention as i8

    scale = 1.0 / math.sqrt(D)
    rows, err = {}, {}
    src = "omnibiote_tpu_torch/ops/csrc/"

    def row(name, source, line, ms, plain_ms, bound, lib):
        # past 256: #1-#8 are the slice kernels of wide_attention.cuh, built
        # into each library, but for the bf16 forward (#1, #6) up to 512 and
        # the bf16 backwards (#2-#5, #7, #8) at 384 and 512, the cluster
        # kernels of mh_flash_bwd_pair.cuh
        if D in fa.PAIR_BWD_HEAD_DIMS and name not in ("mh_flash_fwd", "flash_fwd",
                                                       "int8_flash_fwd"):
            source = "mh_flash_bwd_pair.cuh"
        elif D > 256 and name != "int8_flash_fwd" and not (
                name in ("mh_flash_fwd", "flash_fwd") and D <= fa.WIDE_FWD_MAX_HEAD_DIM):
            source = "wide_attention.cuh"
        rows[name] = {"name": f"{name} D={D}", "route": "cuda", "source": src + source,
                      "replaces": line, "launches": None, "max_abs_err": err[name],
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                      "bound_by": bound[1], "library_ms": lib}

    # #1 at the serving shape: B 32, T 1024, dense, no dropout
    B, T = SERVING_BATCH, 1024
    q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 2100)
    ms = cuda_ms(lambda: fa.mh_flash_forward(q, k, v, None, rope, scale=scale), 20)
    plain = cuda_ms(lambda: fa.mh_flash_forward_plain(q, k, v, None, rope, scale=scale), 3,
                    warmup=1)
    err["mh_flash_fwd"] = _hold_fwd(
        fa.mh_flash_forward(q, k, v, None, rope, scale=scale),
        fa.mh_flash_forward_plain(q, k, v, None, rope, scale=scale,
                                  block_kv=fa.kernel_kv_tile(torch.bfloat16, D)),
        "bfloat16", f"the serving shape B={B} T={T} D={D}")
    qr, kr = apply_rope_half(q, k, *rope)
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (qr, kr, v))
    lib, alone = _sdpa(qh, kh, vh, scale=scale)
    bound = _attn_bound(B, T, H, D)
    print(f"mh_flash_fwd B={B} T={T} H={H} D={D} bf16 dense: kernel {ms:.4f} ms "
          f"({4.0 * B * T * T * H * D / (ms * 1e-3) / 1e12:.1f} TFLOP/s), plain {plain:.4f} ms, "
          f"SDPA {lib:.4f} ms (alone: {', '.join(f'{n} {t:.4f}' for n, t in alone.items())}), "
          f"bound {bound[0]:.4f} ms ({bound[1]}); max|do| {err['mh_flash_fwd']:.3e}")
    row("mh_flash_fwd", "mh_flash_fwd.cu", "omnibiote_tpu/ops/flash_attention.py:545",
        ms, plain, bound, lib)
    # #9 at the same shape, on the same inputs
    ms8 = cuda_ms(lambda: i8.int8_flash_attention(q, k, v, scale=scale, rope=rope), 20)
    plain8 = cuda_ms(lambda: i8.int8_flash_attention_plain(q, k, v, scale=scale, rope=rope), 3,
                     warmup=1)
    o8 = i8.int8_flash_attention(q, k, v, scale=scale, rope=rope)
    p8 = i8.int8_flash_attention_plain(q, k, v, scale=scale, rope=rope)
    rt, at = INT8_TOL["bfloat16"]
    check(torch.allclose(o8.float(), p8.float(), rtol=rt, atol=at),
          f"int8 kernel disagrees with its plain version at B={B} T={T} D={D}")
    cos8 = torch.nn.functional.cosine_similarity(
        o8.float().reshape(-1, D).double(), p8.float().reshape(-1, D).double(), dim=1).min().item()
    check(cos8 >= MIN_COSINE, f"int8 kernel vs plain at D={D}: min row cosine {cos8}")
    err["int8_flash_fwd"] = _abs_err(o8, p8)
    bound8 = _int8_bound(B, T, H, D, 2)
    print(f"int8_flash_fwd B={B} T={T} H={H} D={D} bf16 dense: kernel {ms8:.4f} ms, plain "
          f"{plain8:.4f} ms, SDPA bf16 {lib:.4f} ms, bound {bound8[0]:.4f} ms ({bound8[1]}); "
          f"max|do| {err['int8_flash_fwd']:.3e}, min row cosine vs plain int8 {cos8:.7f} "
          f"(threshold {MIN_COSINE})")
    row("int8_flash_fwd", "int8_flash_fwd.cu", "omnibiote_tpu/ops/int8_attention.py:48",
        ms8, plain8, bound8, lib)
    del q, k, v, qr, kr, qh, kh, vh, o8, p8
    torch.cuda.empty_cache()

    # #1's training call, #2, #6-#8 at bench.py's micro-batch (B 16, T 1024,
    # 3 EOS a row, dropout 0.1); #3-#5 at bench_longctx.py's (B 8, T 2048,
    # 5 EOS a row); skipping on as the main paths run them
    for (B, T, n_eos) in ((TRAIN_SHAPE["B"], 1024, 3), (LONG_SHAPES[0][0], 2048, LONG_EOS)):
        q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 2200 + T)
        seg = _wide_ids("packed", B, T, n_eos, 2200 + T)
        gen = torch.Generator(device="cuda").manual_seed(2300 + T)
        do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
        sb = fa.SegmentBounds(seg)
        kw = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=2561)
        skip = dict(segment_skip=True, bounds=sb)
        o, lse = fa.mh_flash_forward(q, k, v, seg, rope, **kw, **skip)
        di = (o.float() * do.float()).sum(-1)
        args = (q, k, v, do, lse, di, seg, rope)
        pairs = _visible_pairs(seg, B, T)
        (bq, bkv), (kq, kkv), (dq_q, dq_kv) = (fa.kernel_tiles(kind, torch.bfloat16, D)
                                               for kind in ("fused", "dkv", "dq"))
        want = fa.mh_flash_backward_plain(*args, block_q=bq, block_kv=bkv, **kw, **skip)
        qr, kr = apply_rope_half(q, k, *rope)
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (qr, kr, v))
        doh = do.transpose(1, 2).contiguous()
        lib_f, alone = _sdpa(qh.detach(), kh.detach(), vh.detach(), dropout_p=TRAIN_DROPOUT,
                             scale=scale)
        import torch.nn.functional as F
        lib_b = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=TRAIN_DROPOUT, scale=scale), (qh, kh, vh), doh), 10) - lib_f
        shape = f"B={B} T={T} H={H} D={D} bf16, {n_eos} EOS a row, dropout {TRAIN_DROPOUT}"
        print(f"{shape}: visible share of (q, k) pairs {pairs / (B * T * T):.4f}; SDPA dense "
              f"forward {lib_f:.4f} ms (alone: "
              f"{', '.join(f'{n} {t:.4f}' for n, t in alone.items())}), backward {lib_b:.4f} ms")
        if T == 1024:
            ms_f = cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, rope, **kw, **skip), 20)
            print(f"  mh_flash_fwd with skipping {ms_f:.4f} ms, bound "
                  f"{_attn_bound(B, T, H, D, pairs)[0]:.4f} ms over visible pairs")
            got = fa.mh_flash_backward(*args, **kw, **skip)
            rel, err["mh_flash_bwd"] = _hold_bwd(got, want, "bfloat16", shape)
            ms = cuda_ms(lambda: fa.mh_flash_backward(*args, **kw, **skip), 20)
            plain = cuda_ms(lambda: fa.mh_flash_backward_plain(*args, **kw), 3, warmup=1)
            bound = _bwd_bound(B, T, H, D, pairs)
            print(f"  mh_flash_bwd {ms:.4f} ms ({10.0 * pairs * H * D / (ms * 1e-3) / 1e12:.1f} "
                  f"TFLOP/s over visible pairs), plain {plain:.4f} ms, bound {bound[0]:.4f} ms "
                  f"({bound[1]}); max|d|/max|g| {rel:.2e}")
            row("mh_flash_bwd", "mh_flash_bwd.cu", "omnibiote_tpu/ops/flash_attention.py:965",
                ms, plain, bound, lib_b)
            # the per-head entry at this shape: no RoPE, no skipping
            kwh = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=2562)
            oh, lseh = fa.mh_flash_forward(q, k, v, seg, None, **kwh)
            argsh = (q, k, v, do, lseh, (oh.float() * do.float()).sum(-1), seg, None)
            err["flash_fwd"] = _hold_fwd((oh, lseh), fa.mh_flash_forward_plain(
                q, k, v, seg, None, block_kv=fa.kernel_kv_tile(torch.bfloat16, D), **kwh),
                "bfloat16", f"per-head {shape}")
            wanth = fa.mh_flash_backward_plain(*argsh, **kwh)
            err["flash_bwd_dkv"] = _hold_bwd(fa.mh_flash_bwd_dkv(*argsh, **kwh), wanth[1:],
                                             "bfloat16", f"per-head dkv {shape}")[1]
            err["flash_bwd_dq"] = _hold_bwd((fa.mh_flash_bwd_dq(*argsh, **kwh),), wanth[:1],
                                            "bfloat16", f"per-head dq {shape}")[1]
            qn, kn = (x.transpose(1, 2).contiguous() for x in (q, k))
            lib_h, _ = _sdpa(qn, kn, vh.detach(), dropout_p=TRAIN_DROPOUT, scale=scale)
            nb = 4 * B * T * H * D * 2 + B * T * H * 4
            for name, fn, pfn, bound, lib in (
                    ("flash_fwd", lambda: fa.mh_flash_forward(q, k, v, seg, None, **kwh),
                     lambda: fa.mh_flash_forward_plain(q, k, v, seg, None, **kwh),
                     _bound(4.0 * pairs * H * D, nb), lib_h),
                    ("flash_bwd_dkv", lambda: fa.mh_flash_bwd_dkv(*argsh, **kwh),
                     lambda: fa.mh_flash_bwd_dkv_plain(*argsh, **kwh),
                     _bwd_bound(B, T, H, D, pairs, "dkv"), None),
                    ("flash_bwd_dq", lambda: fa.mh_flash_bwd_dq(*argsh, **kwh),
                     lambda: fa.mh_flash_bwd_dq_plain(*argsh, **kwh),
                     _bwd_bound(B, T, H, D, pairs, "dq"), None)):
                ms, plain = cuda_ms(fn, 20), cuda_ms(pfn, 3, warmup=1)
                print(f"  {name} (per-head, every tile) {ms:.4f} ms, plain {plain:.4f} ms, "
                      f"bound {bound[0]:.4f} ms ({bound[1]}) over visible pairs"
                      + (f", SDPA {lib:.4f} ms" if lib is not None else ""))
                line = {"flash_fwd": ("mh_flash_fwd.cu", 110), "flash_bwd_dkv":
                        ("mh_flash_bwd_dkv.cu", 240), "flash_bwd_dq": ("mh_flash_bwd_dq.cu", 301)}
                row(name, line[name][0], f"omnibiote_tpu/ops/flash_attention.py:{line[name][1]}",
                    ms, plain, bound, lib)
            del oh, lseh, argsh, wanth, qn, kn
        else:
            got = fa.mh_flash_backward(*args, **kw, **skip)
            err["mh_flash_bwd_mk"] = _hold_bwd(got, want, "bfloat16", f"fused {shape}")[1]
            err["mh_flash_bwd_dkv"] = _hold_bwd(fa.mh_flash_bwd_dkv(*args, **kw, **skip),
                                                want[1:], "bfloat16", f"dkv {shape}")[1]
            err["mh_flash_bwd_dq"] = _hold_bwd((fa.mh_flash_bwd_dq(*args, **kw, **skip),),
                                               want[:1], "bfloat16", f"dq {shape}")[1]
            for name, fn, pfn, kind, source, line, lib in (
                    ("mh_flash_bwd_mk", lambda: fa.mh_flash_backward(*args, **kw, **skip),
                     lambda: fa.mh_flash_backward_plain(*args, **kw), "fused",
                     "mh_flash_bwd.cu", 1128, lib_b),
                    ("mh_flash_bwd_dkv", lambda: fa.mh_flash_bwd_dkv(*args, **kw, **skip),
                     lambda: fa.mh_flash_bwd_dkv_plain(*args, **kw), "dkv",
                     "mh_flash_bwd_dkv.cu", 773, None),
                    ("mh_flash_bwd_dq", lambda: fa.mh_flash_bwd_dq(*args, **kw, **skip),
                     lambda: fa.mh_flash_bwd_dq_plain(*args, **kw), "dq",
                     "mh_flash_bwd_dq.cu", 866, None)):
                ms, plain = cuda_ms(fn, 10), cuda_ms(pfn, 2, warmup=1)
                bound = _bwd_bound(B, T, H, D, pairs, kind)
                print(f"  {name} {ms:.4f} ms, plain {plain:.4f} ms, bound {bound[0]:.4f} ms "
                      f"({bound[1]}) over visible pairs; max|d| {err[name]:.3e}")
                row(name, source, f"omnibiote_tpu/ops/flash_attention.py:{line}", ms, plain,
                    bound, lib)
        del q, k, v, do, o, lse, args, want, got, qr, kr, qh, kh, vh, doh
        torch.cuda.empty_cache()
    return rows


def _wide_serving(workdir, tok_path, seqs, H=WIDE_HEADS, D=WIDE_D, rate8=None):
    """The Encoder at omnibiote-small width with H heads of D, bf16 and
    int8, on the serving slice's sequences; encode(mean) seq/s beside the
    8-head model's (measured here unless `rate8` gives it from this run).
    Returns (the launches of its runs (#1 and #9), the 8-head rate)."""
    import torch
    from omnibiote_tpu_torch import init_params, preset
    from omnibiote_tpu_torch.api import Encoder
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import attention as port_attention
    from omnibiote_tpu_torch.ops.int8_attention import int8_flash_attention_plain
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor

    sp = SentencePieceProcessor(tok_path)
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.0, n_head=H)
    check((cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.n_embd // cfg.n_head) == (8, 1024, H, D),
          f"unexpected wide config {cfg}")
    L, bs = cfg.n_layer, SERVING_BATCH
    n_batches = -(-len(seqs) // bs)
    gen = torch.Generator(device="cuda").manual_seed(19)
    model = init_params(gen, cfg, device="cuda")
    runs = SERVING_RUNS
    launches = {}

    def encode_all(enc, counter):
        outs = {}
        for method, masked in runs:
            before = dict(_kernels.LAUNCHES)
            out = enc.encode_sequences(seqs, method=method, batch_size=bs, mask_padding=masked)
            check(out.shape == (len(seqs), cfg.n_embd)
                  and bool(torch.isfinite(torch.from_numpy(out)).all()),
                  f"wide {method}/{masked}: shape {out.shape} or non-finite")
            if counter is not None:
                check(_kernels.LAUNCHES[counter] - before[counter] == L * n_batches
                      and sum(_kernels.LAUNCHES.values()) - sum(before.values()) == L * n_batches,
                      f"wide {method}/{masked}: launches {_kernels.LAUNCHES} after {before}")
            outs[(method, masked)] = out
        return outs

    enc = Encoder(model, sp, device="cuda")
    _kernels.reset_launches()
    outs = encode_all(enc, "mh_flash_fwd")
    launches["mh_flash_fwd"] = _kernels.LAUNCHES["mh_flash_fwd"]
    with _plain_attention():
        plain = encode_all(enc, None)
    worst = min(_min_row_cosine(outs[key], plain[key]) for key in runs)
    print(f"wide serving: {cfg.n_layer}L/{cfg.n_embd}d/{cfg.n_head} heads of "
          f"{cfg.n_embd // cfg.n_head}, {len(runs)} encode_sequences calls, "
          f"{launches['mh_flash_fwd']} mh_flash_fwd launches; vs the plain attention min row "
          f"cosine {worst:.7f} (threshold {MIN_COSINE})")
    check(worst >= MIN_COSINE, "wide Encoder: kernel vs plain attention")
    del plain

    enc8 = Encoder(model, sp, quantize=True, quantize_attention=True, device="cuda")
    _kernels.reset_launches()
    outs8 = encode_all(enc8, "int8_flash_fwd")
    launches["int8_flash_fwd"] = _kernels.LAUNCHES["int8_flash_fwd"]
    kernel_fn = port_attention.int8_flash_attention
    port_attention.int8_flash_attention = int8_flash_attention_plain
    try:
        plain8 = encode_all(enc8, None)
    finally:
        port_attention.int8_flash_attention = kernel_fn
    worst_plain = min(_min_row_cosine(outs8[key], plain8[key]) for key in runs)
    worst_bf16 = min(_min_row_cosine(outs8[key], outs[key]) for key in runs)
    print(f"wide int8 serving: Encoder(quantize=True, quantize_attention=True), "
          f"{launches['int8_flash_fwd']} int8_flash_fwd launches; vs plain int8 attention min "
          f"row cosine {worst_plain:.7f} (threshold {MIN_COSINE}), vs the bf16 Encoder "
          f"{worst_bf16:.6f} (threshold {MIN_COSINE_INT8})")
    check(worst_plain >= MIN_COSINE, "wide int8 Encoder: kernel vs plain int8 attention")
    check(worst_bf16 >= MIN_COSINE_INT8, "wide int8 Encoder vs the bf16 Encoder")

    x = torch.randint(20, 65000, (bs, cfg.block_size), generator=gen, device="cuda")
    rate4 = _encode_rate(model, x, f"{H} heads of {D}, bf16")
    rate4_8 = _encode_rate(enc8.model, x, f"{H} heads of {D}, int8 weights + "
                           f"int8 attention")
    del enc, enc8, model, outs, outs8, plain8
    torch.cuda.empty_cache()
    if rate8 is None:
        cfg8 = preset("omnibiote-small", vocab_size=65536, dropout=0.0)
        model8 = init_params(gen, cfg8, device="cuda")
        rate8 = _encode_rate(model8, x, "8 heads of 128, bf16")
        del model8
        torch.cuda.empty_cache()
    print(f"encode(mean) B={bs} T={cfg.block_size} in one run: {H} heads of {D} "
          f"{rate4:.1f} seq/s (int8 {rate4_8:.1f}), 8 heads of 128 {rate8:.1f} seq/s "
          f"(ratio {rate4 / rate8:.4f})")
    return launches, rate8


def _wide_training(workdir, H=WIDE_HEADS, D=WIDE_D, tps8=None):
    """Training at omnibiote-small width with H heads of D: at ctx 1024
    (16 x 2, 3 EOS, dropout 0.1) one micro-batch and one step on the kernels
    against the plain attention, the CLI with --n_head H for 2 steps, and
    tokens/s over 6 steps beside 8 heads of 128 (measured here unless
    `tps8` gives it from this run); at ctx 2048 (8 x 2, 5 EOS) one step
    with the fused backward (#3) and one with the split pair (#4, #5)
    against plain, and tokens/s over 4 steps. Returns (the launches of
    those runs, the 8-head rate)."""
    import copy
    import torch
    from omnibiote_tpu_torch import preset
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.models.omnibiota import init_params
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.training import cli
    from omnibiote_tpu_torch.training.mlm import mlm_loss
    from omnibiote_tpu_torch.training.optim import make_optimizer
    from omnibiote_tpu_torch.training.train import _compute_copy, make_train_step

    launches = {}
    for mini, accum, ctx, n_eos in ((16, 2, 1024, 3), (LONG_SHAPES[0][0], 2, 2048, LONG_EOS)):
        cfg = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                     n_head=H, block_size=ctx)
        L = cfg.n_layer
        tc = TrainConfig(batch_size=mini * accum, mini_batch_size=mini, ctx_len=ctx,
                         token_budget=float(mini * accum * ctx * 10000), seed=0)
        batch = next(bench_batches(mini * accum, ctx, 19, n_eos))
        tokens = torch.from_numpy(batch["tokens"]).cuda().view(accum, mini, ctx)
        segments = torch.from_numpy(batch["segments"]).cuda().view(accum, mini, ctx)
        gen = torch.Generator(device="cuda").manual_seed(19)
        model = init_params(gen, cfg, device="cuda")
        bwd = "mh_flash_bwd" if ctx <= 1024 else "mh_flash_bwd_mk"
        tag = f"{H} heads of {D}, mini {mini} x {accum}, T {ctx}"

        if ctx == 1024:
            def loss_and_grads():
                params_c = _compute_copy(dict(model.named_parameters()), cfg)
                loss, _ = mlm_loss(model, tokens[0], segments[0], 1234, params=params_c)
                grads = torch.autograd.grad(loss, list(params_c.values()))
                return loss.item(), dict(zip(params_c, grads))

            _kernels.reset_launches()
            loss_k, grads_k = loss_and_grads()
            check(_kernels.LAUNCHES == _counts(mh_flash_fwd=L, mh_flash_bwd=L),
                  f"wide micro-batch launched {_kernels.LAUNCHES}")
            with _plain_attention():
                loss_p, grads_p = loss_and_grads()
            worst_cos = min(torch.nn.functional.cosine_similarity(
                grads_k[n].double().flatten(), grads_p[n].double().flatten(), dim=0).item()
                for n in grads_k)
            print(f"wide micro-batch ({tag}): loss kernels {loss_k:.6f} plain {loss_p:.6f} "
                  f"(|d| {abs(loss_k - loss_p):.2e}, limit {TRAIN_LOSS_ATOL}); worst gradient "
                  f"cosine {worst_cos:.6f} (limit {TRAIN_GRAD_COS})")
            check(abs(loss_k - loss_p) <= TRAIN_LOSS_ATOL, "wide micro-batch loss")
            check(worst_cos >= TRAIN_GRAD_COS, "wide micro-batch gradients")
            del grads_k, grads_p

        def one_step(m):
            params = dict(m.named_parameters())
            opt = make_optimizer(list(params), cfg, tc, 10000)
            state = opt.init(params)
            step = make_train_step(m, cfg, tc, opt)
            return step(params, state, tokens, segments, [1.0] * accum, 99, 0)

        with _plain_attention():
            met_p = one_step(copy.deepcopy(model))
        gn_p = float(met_p["grad_norm"])
        for fused in ((True,) if ctx == 1024 else (True, False)):
            name = "fused backward" if fused else "split pair"
            with _attention_switch(FUSED_MULTIKV_BWD=fused):
                _kernels.reset_launches()
                met_k = one_step(copy.deepcopy(model))
                step_launches = dict(_kernels.LAUNCHES)
            want = (_counts(mh_flash_fwd=L * accum, **{bwd: L * accum}) if fused else
                    _counts(mh_flash_fwd=L * accum, mh_flash_bwd_dkv=L * accum,
                            mh_flash_bwd_dq=L * accum))
            check(step_launches == want, f"wide step ({tag}, {name}) launched {step_launches}")
            for n, c in step_launches.items():
                launches[n] = launches.get(n, 0) + c
            gn_k = float(met_k["grad_norm"])
            print(f"wide train step ({tag}, {name}): grad_norm kernels {gn_k:.6f} plain "
                  f"{gn_p:.6f} (relative {abs(gn_k - gn_p) / gn_p:.2e}, limit "
                  f"{TRAIN_GNORM_RTOL}); loss {float(met_k['loss']):.6f} vs "
                  f"{float(met_p['loss']):.6f}; launches {want}")
            check(abs(gn_k - gn_p) <= TRAIN_GNORM_RTOL * gn_p, f"wide step grad_norm ({name})")
        del model, met_k, met_p
        torch.cuda.empty_cache()

        if ctx == 1024:
            # the CLI with --n_head H: the training main path at this width
            data = os.path.join(workdir, f"data_wide_{D}")
            log = os.path.join(workdir, f"metrics_wide_{D}.jsonl")
            _write_shards(data, 300_000, seed=19)
            steps = 2
            argv = ["--base_dir", data, "--train_type", "mixed", "--n_layer", str(L),
                    "--n_embd", "1024", "--n_head", str(H), "--ctx_len", str(ctx),
                    "--dropout", str(TRAIN_DROPOUT), "--mini_batch_size", str(mini),
                    "--batch_size", str(mini * accum), "--max_steps", str(steps),
                    "--save_dir", os.path.join(workdir, f"ckpt_wide_{D}"), "--log_every", "1",
                    "--test_freq", "50000", "--metrics_jsonl", log]
            print("wide train CLI: python -m omnibiote_tpu_torch.training.cli " + " ".join(argv))
            _kernels.reset_launches()
            trainer = cli.run(argv)
            torch.cuda.synchronize()
            cli_launches = dict(_kernels.LAUNCHES)
            check(trainer.model.cfg.n_head == H, "the CLI's model has other heads")
            with open(log) as f:
                recs = [json.loads(line) for line in f]
            losses = [r["loss"] for r in recs if "loss" in r]
            probes = [k for r in recs for k in r if k.startswith("test_loss/")]
            check(len(losses) == steps and all(math.isfinite(x) for x in losses),
                  f"wide CLI losses {losses}")
            want = _counts(mh_flash_fwd=steps * L * accum + len(probes) * L,
                           mh_flash_bwd=steps * L * accum)
            print(f"wide train CLI: {steps} steps, losses {[round(x, 4) for x in losses]}, "
                  f"{len(probes)} validation probes, launches {cli_launches} (want {want})")
            check(cli_launches == want, f"wide CLI launches {cli_launches}")
            for n, c in cli_launches.items():
                launches[n] = launches.get(n, 0) + c
            del trainer
            torch.cuda.empty_cache()
            tps4 = _throughput(cfg, tc, n_eos, 6, f"ctx {ctx}, {H} heads of {D}")
            if tps8 is None:
                cfg8 = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT)
                tps8 = _throughput(cfg8, tc, n_eos, 6, f"ctx {ctx}, 8 heads of 128")
            print(f"train tokens/s at ctx {ctx}, mini {mini} x {accum}, in one run: "
                  f"{H} heads of {D} {tps4:.1f}, 8 heads of 128 {tps8:.1f} "
                  f"(ratio {tps4 / tps8:.4f})")
        else:
            tps4 = _throughput(cfg, tc, n_eos, 4, f"ctx {ctx}, {H} heads of {D}")
    return launches, tps8


def _head_dim_phase(workdir, tok_path, seqs, H, D, phase, checks, baseline=None):
    """Phase 19 or 20 after its small-shape `checks` (a callable returning
    the worst bf16 errors): each kernel at H heads of D timed at its path's
    shape, and omnibiote-small with H heads of D served, trained and run
    through the per-head entry. baseline: the 8-head rates (`rate8`,
    `tps8`) already measured in this run, or None. Returns (the rows of the
    kernels line, each row's launches from this phase's main paths, the
    worst bf16 errors, the 8-head rates)."""
    t0 = time.time()
    baseline = baseline or {}
    worst = checks()
    print(f"phase {phase}: the small-shape checks took {time.time() - t0:.1f} s")
    rows = _wide_timings(H, D)
    serving, rate8 = _wide_serving(workdir, tok_path, seqs, H, D, baseline.get("rate8"))
    training, tps8 = _wide_training(workdir, H, D, baseline.get("tps8"))
    per_head = _wide_per_head(H, D)
    launches = {**training, **serving, **per_head}
    launches["mh_flash_fwd"] = serving["mh_flash_fwd"] + training.get("mh_flash_fwd", 0)
    order = ("mh_flash_fwd", "mh_flash_bwd", "mh_flash_bwd_mk", "mh_flash_bwd_dkv",
             "mh_flash_bwd_dq", "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "int8_flash_fwd")
    check(sorted(rows) == sorted(order), f"phase {phase}'s rows {sorted(rows)}")
    for name, row in rows.items():
        row["launches"] = launches.get(name, 0)
        check(row["launches"] > 0, f"phase {phase}'s main paths never launched {name} at D={D}")
    print(f"phase {phase} (head dim {D}): {time.time() - t0:.1f} s; main-path launches "
          f"{ {n: rows[n]['launches'] for n in order} }")
    return [rows[n] for n in order], worst, {"rate8": rate8, "tps8": tps8}


def head_dim_256_phase(workdir, tok_path, seqs):
    """Phase 19: the kernels at D = 256 and one head at D = 96 and 32
    against their plain versions, their times at the paths' shapes, and
    omnibiote-small with 4 heads of 256 served and trained. Returns
    _head_dim_phase's."""
    def checks():
        worst = _wide_kernel_checks()
        _wide_padded_checks()
        return worst
    return _head_dim_phase(workdir, tok_path, seqs, WIDE_HEADS, WIDE_D, 19, checks)


# omnibiote-small's width with 2 heads of 512 (`--n_head 2`), the same 168 M
# parameters and attention FLOPs a token as its 8 heads of 128; the kernels
# past 256 are checked at three head dims on small shapes first, and one
# head at two head dims that run padded.
WIDER_HEADS, WIDER_D = 2, 512
WIDER_CHECK_DIMS = (384, 512, 1024)
WIDER_LAYOUTS = (("dense", 256, 0), ("packed", 256, 3), ("padded", 256, 0),
                 ("packed", 512, LONG_EOS))
WIDER_PADDED = (320, 600)


def _wider_int8_checks():
    """#9 at each head dim of WIDER_CHECK_DIMS (2 heads, B 1, T 256, RoPE),
    bf16 and fp32, dense and packed rows: its prologue bit for bit and its
    output against the plain version (_hold_int8)."""
    import torch
    errs = []
    for i, D in enumerate(WIDER_CHECK_DIMS):
        for dtype in ("bfloat16", "float32"):
            for layout in ("dense", "packed"):
                q, k, v, _, rope = _attn_inputs(1, 256, WIDER_HEADS, D, getattr(torch, dtype),
                                                "dense", seed=2600 + i)
                seg = _wide_ids(layout, 1, 256, 3, 2600 + i)
                err, _ = _hold_int8(q, k, v, seg, rope, 1.0 / math.sqrt(D),
                                    f"D={D} {dtype} {layout}")
                errs.append(err)
    print(f"int8 kernel past 256 at D {WIDER_CHECK_DIMS}, bf16 and fp32, dense and packed: "
          f"prologue bit for bit, max|do| {max(errs):.3e}")


def _pair_bwd_checks(dims=(384, 512), seed=2700):
    """The bf16 fused backward's cluster kernel (mh_flash_bwd.cu::
    mh_bwd_pair) at each head dim of `dims` (2 heads) over WIDE_LAYOUTS at
    dropout 0 and 0.1: #2 at T = 1024 (B 2, counted as the single-kv
    backward) and #3 at T = 2048 (B 1, 128-wide kv blocks: counted as the
    multi-kv one), both with skipping as the dispatch runs them, against the
    plain version at BWD_TOL; bounds on against the full walk (dk and dv the
    same bits, dq within the atomics' tolerance); the tiles walked against
    the bounds' count; the library's route (and fp32's, still the slice
    kernel) and the launches. Returns the worst bf16 max |d|."""
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    route = _kernels.load_library("mh_flash_bwd").obt_mh_flash_bwd_route
    H, worst, t0 = WIDER_HEADS, 0.0, time.time()
    for D in dims:
        routes = (route(D, 1).decode(), route(D, 0).decode())
        check(D in fa.PAIR_BWD_HEAD_DIMS and routes == ("mh_bwd_pair", "mh_bwd_wide"),
              f"fused backward at D={D} routes bf16, fp32 to {routes}")
        scale = 1.0 / math.sqrt(D)
        bq, bkv = fa.kernel_tiles("fused", torch.bfloat16, D)
        for i, (layout, T, n_eos) in enumerate(WIDE_LAYOUTS):
            for rate in (0.0, TRAIN_DROPOUT):
                B = 2 if T == 1024 else 1
                counter = "mh_flash_bwd" if T == 1024 else "mh_flash_bwd_mk"
                tag = f"D={D} B={B} T={T} bf16 {layout}{n_eos or ''} dropout {rate} ({counter})"
                s0 = seed + 10 * i + D + int(100 * rate)
                q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", seed=s0)
                seg = _wide_ids(layout, B, T, n_eos, s0)
                gen = torch.Generator(device="cuda").manual_seed(s0 + 1)
                do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
                kw = dict(scale=scale, dropout_rate=rate, seed=0x5A1 + s0)
                sb = None if seg is None else fa.SegmentBounds(seg)
                bounds = fa._kernel_bounds("fused", q, seg, True, sb)
                n_want = (H * B * (T // bq) * (T // bkv) if bounds is None
                          else H * int((bounds[1] - bounds[0] + 1).sum()))
                o, lse = fa.mh_flash_forward(q, k, v, seg, rope, segment_skip=True, bounds=sb,
                                             **kw)
                di = (o.float() * do.float()).sum(-1)
                args = (q, k, v, do, lse, di, seg, rope)
                _kernels.reset_launches()
                got = _walked(lambda c: fa.mh_flash_backward_kernel(
                    *args, tile_bounds=bounds, tile_count=c, counter=counter, **kw), n_want, tag)
                got_all = fa.mh_flash_backward_kernel(*args, counter=counter, **kw)
                torch.cuda.synchronize()
                check(_kernels.LAUNCHES == _counts(**{counter: 2}),
                      f"{tag}: launches {_kernels.LAUNCHES}")
                want = fa.mh_flash_backward_plain(*args, block_q=bq, block_kv=bkv,
                                                  segment_skip=True, bounds=sb, **kw)
                rel, err = _hold_bwd(got, want, "bfloat16", tag)
                same = (torch.equal(got[1], got_all[1]) and torch.equal(got[2], got_all[2])
                        and _rel_err(got[0], got_all[0]) <= BWD_TOL["bfloat16"])
                check(same, f"{tag}: bounds on differ from the full walk")
                worst = max(worst, err)
                print(f"mh_bwd_pair {tag}: route {routes[0]}, tiles walked {n_want} (as the "
                      f"bounds give), max|d|/max|g| vs plain {rel:.2e} (tolerance "
                      f"{BWD_TOL['bfloat16']}), max|d| {err:.3e}; bounds on == off (dk, dv "
                      f"the same bits, dq within tolerance)")
                del q, k, v, do, o, lse, di, args, got, got_all, want
                torch.cuda.empty_cache()
    print(f"mh_bwd_pair checks: {time.time() - t0:.1f} s, worst max|d| {worst:.3e}")
    return worst


def _split_pair_checks(dims=(384, 512), seed=2800):
    """The bf16 split pair's kernels (mh_flash_bwd_pair.cuh::mh_bwd_pair
    without its dQ, #4, a cluster; mh_bwd_dq_cta, #5) at each head dim of
    `dims` (2 heads) over WIDE_LAYOUTS at dropout 0 and 0.1 (B 2 at T 1024,
    1 at 2048), with skipping as the dispatch runs them, against the plain
    backward at BWD_TOL; dq, dk and dv the same bits at a second launch and
    with bounds on against the full walk (the split pair's contract); the
    tiles walked against the bounds' count; then the per-head entry's #7 and
    #8 (packed, dropout 0.1, no RoPE, counted under flash_bwd_*); the
    libraries' routes (fp32, and bf16 at D = 640 and 1024, still the slice
    kernels) and the launches. Returns the worst bf16 max |d|."""
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    dkv_route = _kernels.load_library("mh_flash_bwd_dkv").obt_mh_flash_bwd_dkv_route
    dq_route = _kernels.load_library("mh_flash_bwd_dq").obt_mh_flash_bwd_dq_route
    slices = ("mh_bwd_wide", "mh_bwd_dq_wide")
    for D in (*dims, 640, 1024):
        routes = {dt: (dkv_route(D, dt).decode(), dq_route(D, dt).decode()) for dt in (1, 0)}
        want = {1: ("mh_bwd_pair", "mh_bwd_dq_cta") if D in fa.PAIR_BWD_HEAD_DIMS else slices,
                0: slices}
        check(routes == want, f"split pair at D={D} routes (bf16, fp32) to {routes}")
        print(f"split pair routes at D={D}: bf16 {routes[1]}, fp32 {routes[0]}")
    H, worst, t0 = WIDER_HEADS, 0.0, time.time()
    for D in dims:
        scale = 1.0 / math.sqrt(D)
        for i, (layout, T, n_eos) in enumerate(WIDE_LAYOUTS):
            for rate in (0.0, TRAIN_DROPOUT):
                B = 2 if T == 1024 else 1
                tag = f"D={D} B={B} T={T} bf16 {layout}{n_eos or ''} dropout {rate}"
                s0 = seed + 10 * i + D + int(100 * rate)
                q, k, v, _, rope = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", seed=s0)
                seg = _wide_ids(layout, B, T, n_eos, s0)
                gen = torch.Generator(device="cuda").manual_seed(s0 + 1)
                do = torch.randn(B, T, H, D, generator=gen, device="cuda").bfloat16()
                kw = dict(scale=scale, dropout_rate=rate, seed=0x5B2 + s0)
                sb = None if seg is None else fa.SegmentBounds(seg)
                o, lse = fa.mh_flash_forward(q, k, v, seg, rope, segment_skip=True, bounds=sb,
                                             **kw)
                di = (o.float() * do.float()).sum(-1)
                args = (q, k, v, do, lse, di, seg, rope)
                _kernels.reset_launches()
                runs, walked = {}, {}
                for kind, fn in (("dkv", fa.mh_flash_bwd_dkv_kernel),
                                 ("dq", fa.mh_flash_bwd_dq_kernel)):
                    bounds = fa._kernel_bounds(kind, q, seg, True, sb)
                    tq, tkv = fa.kernel_tiles(kind, torch.bfloat16, D)
                    own, step = (tkv, tq) if kind == "dkv" else (tq, tkv)
                    walked[kind] = (H * B * (T // own) * (T // step) if bounds is None
                                    else H * int((bounds[1] - bounds[0] + 1).sum()))
                    tup = lambda x: x if isinstance(x, tuple) else (x,)
                    runs[kind] = [tup(_walked(lambda c: fn(*args, tile_bounds=bounds,
                                                           tile_count=c, **kw),
                                              walked[kind], f"{kind} {tag}")),
                                  tup(fn(*args, **kw)), tup(fn(*args, tile_bounds=bounds, **kw))]
                torch.cuda.synchronize()
                check(_kernels.LAUNCHES == _counts(mh_flash_bwd_dkv=3, mh_flash_bwd_dq=3),
                      f"{tag}: launches {_kernels.LAUNCHES}")
                same = all(torch.equal(a, b) for got, full, again in runs.values()
                           for a, b in (*zip(got, full), *zip(got, again)))
                check(same, f"{tag}: the split pair with bounds differs from the full walk, "
                      f"or a second launch from the first")
                want = fa.mh_flash_backward_plain(*args, **kw)
                rel, err = _hold_bwd((*runs["dq"][0], *runs["dkv"][0]), want, "bfloat16", tag)
                worst = max(worst, err)
                print(f"split pair {tag}: tiles walked dkv {walked['dkv']}, dq {walked['dq']} (as "
                      f"the bounds give), max|d|/max|g| vs plain {rel:.2e} (tolerance "
                      f"{BWD_TOL['bfloat16']}), max|d| {err:.3e}; dq, dk, dv bounds on == off "
                      f"and at a second launch the same bits")
                del q, k, v, do, o, lse, di, args, runs, want
                torch.cuda.empty_cache()
        # the per-head entry's calls (#7, #8): no RoPE, no bounds
        B, T = 2, 1024
        q, k, v, _, _ = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", seed=seed + D)
        seg = _wide_ids("packed", B, T, 3, seed + D)
        do = torch.randn(B, T, H, D, generator=torch.Generator(device="cuda").manual_seed(
            seed + D + 1), device="cuda").bfloat16()
        kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=TRAIN_DROPOUT, seed=0x5B3 + D)
        o, lse = fa.mh_flash_forward(q, k, v, seg, None, **kw)
        args = (q, k, v, do, lse, (o.float() * do.float()).sum(-1), seg, None)
        _kernels.reset_launches()
        dk, dv = fa.mh_flash_bwd_dkv(*args, **kw, counter="flash_bwd_dkv")
        dq = fa.mh_flash_bwd_dq(*args, **kw, counter="flash_bwd_dq")
        again = (fa.mh_flash_bwd_dq(*args, **kw, counter="flash_bwd_dq"),
                 *fa.mh_flash_bwd_dkv(*args, **kw, counter="flash_bwd_dkv"))
        torch.cuda.synchronize()
        check(_kernels.LAUNCHES == _counts(flash_bwd_dkv=2, flash_bwd_dq=2),
              f"per-head split pair at D={D}: launches {_kernels.LAUNCHES}")
        check(all(torch.equal(a, b) for a, b in zip((dq, dk, dv), again)),
              f"per-head split pair at D={D}: a second launch differs from the first")
        rel, err = _hold_bwd((dq, dk, dv), fa.mh_flash_backward_plain(*args, **kw), "bfloat16",
                             f"per-head D={D}")
        worst = max(worst, err)
        print(f"split pair per-head entry D={D} B={B} T={T} bf16 packed3 dropout "
              f"{TRAIN_DROPOUT}: max|d|/max|g| vs plain {rel:.2e}, max|d| {err:.3e}; a second "
              f"launch the same bits")
        del q, k, v, do, o, lse, args, dq, dk, dv, again
        torch.cuda.empty_cache()
    print(f"split pair checks: {time.time() - t0:.1f} s, worst max|d| {worst:.3e}")
    return worst


def head_dim_wide_phase(workdir, tok_path, seqs, baseline):
    """Phase 20: #1-#5 at D = 384, 512 and 1024 and #9 there against their
    plain versions on small shapes, the bf16 backwards (the fused cluster,
    the split pair) at D = 384 and 512 on the layouts of the main paths,
    one head at D = 320 and 600 padded,
    then omnibiote-small with 2 heads of 512 as phase 19 runs 4 heads of
    256, beside phase 19's 8-head rates (`baseline`). Returns
    _head_dim_phase's."""
    def checks():
        worst = {"fwd": 0.0, "bwd": 0.0}
        for i, D in enumerate(WIDER_CHECK_DIMS):
            w = _wide_kernel_checks(WIDER_HEADS, D, WIDER_LAYOUTS, seed=2500 + 100 * i,
                                    lse_shape=(1, 512))
            worst = {n: max(worst[n], w[n]) for n in worst}
        worst["bwd"] = max(worst["bwd"], _pair_bwd_checks(), _split_pair_checks())
        _wider_int8_checks()
        _wide_padded_checks(WIDER_PADDED)
        return worst
    return _head_dim_phase(workdir, tok_path, seqs, WIDER_HEADS, WIDER_D, 20, checks,
                           baseline)


def _wide_per_head(H=WIDE_HEADS, D=WIDE_D):
    """flash_attention(multi_head=False) at H heads of D: forward and
    backward against the plain versions (bf16 and fp32, dropout 0.1,
    packed), then its main path at bench.py's micro-batch. Returns the
    launches of that path."""
    import torch
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa

    scale = 1.0 / math.sqrt(D)

    def fwd_bwd(q, k, v, seg, do):
        q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
        o = fa.flash_attention(q, k, v, seg, None, scale=scale, block_q=512, block_kv=512,
                               multi_head=False, dropout_rate=TRAIN_DROPOUT, seed=0x6E)
        return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))

    for i, dtype in enumerate(("bfloat16", "float32")):
        B, T = 2, 1024
        q, k, v, seg, _ = _attn_inputs(B, T, H, D, getattr(torch, dtype), "packed", 2400 + i)
        do = torch.randn(B, T, H, D, device="cuda").to(q.dtype)
        _kernels.reset_launches()
        got = fwd_bwd(q, k, v, seg, do)
        torch.cuda.synchronize()
        check(_kernels.LAUNCHES == _counts(flash_fwd=1, flash_bwd_dkv=1, flash_bwd_dq=1),
              f"per-head entry at D={D} launched {_kernels.LAUNCHES}")
        with _plain_attention():
            want = fwd_bwd(q, k, v, seg, do)
            po, _ = fa.mh_flash_forward_plain(
                q, k, v, seg, None, scale=scale, dropout_rate=TRAIN_DROPOUT, seed=0x6E,
                block_kv=fa.kernel_kv_tile(q.dtype, D))
        rt, at = TOL[dtype]["o"]
        check(torch.allclose(got[0].float(), po.float(), rtol=rt, atol=at),
              f"per-head forward at D={D} {dtype} disagrees with its plain version")
        rel, _ = _hold_bwd(got[1:], want[1:], dtype, f"per-head D={D} {dtype}")
        print(f"per-head entry D={D} B={B} T={T} {dtype} packed dropout {TRAIN_DROPOUT}: "
              f"max|do| {_abs_err(got[0], po):.3e}, backward max|d|/max|g| {rel:.2e}")
    B, T = TRAIN_SHAPE["B"], TRAIN_SHAPE["T"]
    q, k, v, _, _ = _attn_inputs(B, T, H, D, torch.bfloat16, "dense", 2410)
    seg = _wide_ids("packed", B, T, 3, 2410)
    do = torch.randn(B, T, H, D, device="cuda").bfloat16()
    n_calls = 4
    _kernels.reset_launches()
    for _ in range(n_calls):
        fwd_bwd(q, k, v, seg, do)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    check(launches == _counts(flash_fwd=n_calls, flash_bwd_dkv=n_calls, flash_bwd_dq=n_calls),
          f"per-head main path at D={D} launched {launches}")
    print(f"per-head main path at D={D}: {n_calls} forward + backward calls at B={B} T={T}, "
          f"launches {launches}")
    return {n: c for n, c in launches.items() if c}


# ---------------------------------------------------------------------------
# 21. a reference checkpoint (.pt) converted and served
# ---------------------------------------------------------------------------

def _standin():
    """tests/reference_standin.py: the reference's RoPE buffer builder and
    a stand-in for its model.py (its module class, imported from `mup`),
    which the repository's tests build their .pt fixtures with too."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import reference_standin
    finally:
        sys.path.remove(os.path.join(ROOT, "tests"))
    return reference_standin


def _reference_layout(model):
    """The model's state as the reference holds it: fp32 CPU tensors and a
    freqs_cis buffer in every attention block."""
    cfg = model.cfg
    state = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    fc = _standin().precompute_freqs_cis(cfg.n_embd // cfg.n_head, cfg.block_size)
    for i in range(cfg.n_layer):
        state[f"transformer.h.{i}.attn.freqs_cis"] = fc
    return state


def _hold_converted(out_dir, state, cfg, tag):
    """The converted directory holds `state`'s parameters bit for bit and
    `cfg` as its model_cfg."""
    import torch
    from omnibiote_tpu_torch.training.checkpoint import load_params_flat
    from omnibiote_tpu_torch.utils.convert import nest, state_from_jax_params

    with open(os.path.join(out_dir, "meta.json")) as f:
        meta = json.load(f)
    check(meta["model_cfg"] == json.loads(json.dumps(dict(vars(cfg)), default=str))
          and meta["converted_from"] == "reference torch checkpoint",
          f"{tag}: meta.json {meta}")
    got = state_from_jax_params(nest(load_params_flat(out_dir)), cfg)
    names = [k for k in state if not k.endswith("freqs_cis")]
    check(sorted(got) == sorted(names), f"{tag}: converted keys {sorted(got)[:4]}...")
    bad = [k for k in names if not torch.equal(got[k].float(), state[k].float())]
    check(not bad, f"{tag}: converted tensors differ from the seed's: {bad[:4]}")
    return sum(state[k].numel() for k in names)


def _small_forms(workdir):
    """The bare, '_orig_mod.'-prefixed and pickled-module forms at a small
    width (2 layers, d 256, 2 heads of 128, bias) through the converter's
    CLI entry point: each directory holds its seed's tensors bit for bit."""
    import torch
    from omnibiote_tpu_torch import OmniBioTAConfig, init_params
    from omnibiote_tpu_torch.utils import torch_convert

    cfg = OmniBioTAConfig(n_layer=2, n_embd=256, n_head=2, vocab_size=512, block_size=256,
                          bias=True, dropout=0.0)
    model = init_params(torch.Generator(device="cuda").manual_seed(2150), cfg, device="cuda")
    state = _reference_layout(model)
    root = os.path.join(workdir, "ref_small")
    os.makedirs(root)
    forms = {"bare": state, "orig_mod": {"_orig_mod." + k: v for k, v in state.items()}}
    for form, obj in forms.items():
        torch.save(obj, os.path.join(root, f"{form}.pt"))
    # the pickled module, its class in root/model.py, MuReadout from a stub
    standin = _standin()
    standin.save_pickled_module(state, root, os.path.join(root, "module.pt"),
                                block_size=cfg.block_size, vocab_size=cfg.vocab_size,
                                n_layer=cfg.n_layer, n_head=cfg.n_head, n_embd=cfg.n_embd,
                                bias=cfg.bias, dropout=0.1)
    for form in (*forms, "module"):
        out = os.path.join(root, f"{form}_out")
        argv = [os.path.join(root, f"{form}.pt"), out]
        argv += ["--reference_path", root] if form == "module" else []
        with standin.modules_restored("model", "mup"):
            torch_convert.main(argv)
        _hold_converted(out, state, cfg, f"the {form} form")
    print("reference checkpoint, small width (2L/256d/2h, bias): bare, '_orig_mod.' and "
          "pickled-module forms converted through the CLI, each bit for bit")


def reference_checkpoint_phase(workdir, tok_path, seqs, rate16=None):
    """A reference-layout .pt at omnibiote-small full width (seeded µP
    weights, freqs_cis buffers, saved as {"model": {"module." + k: v},
    "step": 7}) through the converter's CLI in a subprocess, then served
    from its output directory: Encoder.from_checkpoint on the card over the
    serving slice's 64 sequences with every pooling (#1), the same through
    quantize_attention (#9), and the FASTA CLI. Returns the launches of its
    main path (#1's and #9's). rate16: phase 3's encode(mean) seq/s of this
    run, printed beside this one's, or None."""
    import numpy as np
    import torch
    from omnibiote_tpu_torch import api, init_params, preset
    from omnibiote_tpu_torch.models.omnibiota import OmniBioTA
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import attention as port_attention
    from omnibiote_tpu_torch.ops.int8_attention import int8_flash_attention_plain
    from omnibiote_tpu_torch.tokenizer import SentencePieceProcessor

    t_phase = time.time()
    _small_forms(workdir)
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.0)
    model = init_params(torch.Generator(device="cuda").manual_seed(2100), cfg, device="cuda")
    state = _reference_layout(model)
    del model
    pt = os.path.join(workdir, "omnibiota_ref.pt")
    torch.save({"model": {"module." + k: v for k, v in state.items()}, "step": 7}, pt)
    pt_gb = os.path.getsize(pt) / 1e9
    out_dir = os.path.join(workdir, "converted")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "omnibiote_tpu_torch.utils.torch_convert",
                           pt, out_dir], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    convert_s = time.time() - t0
    check(proc.returncode == 0, f"the converter CLI failed: {proc.stderr[-2000:]}")
    summary = proc.stdout.strip().splitlines()[-1]
    n_params = _hold_converted(out_dir, state, cfg, "the full-width .pt")
    check(summary == f"converted {n_params:,} params ({cfg.n_layer}L/{cfg.n_embd}d/"
                     f"{cfg.n_head}h, block_size {cfg.block_size}, bias={cfg.bias}) -> "
                     f"{out_dir}", f"the converter's summary: {summary}")
    os.remove(pt)
    print(f"reference checkpoint: {pt_gb:.3f} GB .pt ({n_params:,} parameters, fp32) "
          f"converted by `python -m omnibiote_tpu_torch.utils.torch_convert` in "
          f"{convert_s:.2f} s; {summary}")

    L, bs = cfg.n_layer, SERVING_BATCH
    n_batches = -(-len(seqs) // bs)
    # the same state loaded in memory, for the bit-for-bit comparison
    mem = OmniBioTA(cfg, device="cuda")
    mem.load_state_dict({k: v for k, v in state.items() if not k.endswith("freqs_cis")},
                        strict=True)
    del state
    enc_mem = api.Encoder(mem, SentencePieceProcessor(tok_path), device="cuda")

    def run(enc, counter, other):
        outs = {}
        for method, masked in SERVING_RUNS:
            before = dict(_kernels.LAUNCHES)
            out = enc.encode_sequences(seqs, method=method, batch_size=bs, mask_padding=masked)
            check(out.shape == (len(seqs), cfg.n_embd) and out.dtype.name == "float32"
                  and bool(np.isfinite(out).all()),
                  f"converted {method}/{masked}: {out.shape} {out.dtype} or non-finite")
            check(_kernels.LAUNCHES[counter] - before[counter] == L * n_batches
                  and _kernels.LAUNCHES[other] == before[other],
                  f"converted {method}/{masked}: launches {_kernels.LAUNCHES} after {before}")
            outs[(method, masked)] = out
        return outs

    # -- the main path: from the CLI's directory on the default device ------
    _kernels.reset_launches()
    torch.cuda.synchronize()
    enc = api.Encoder.from_checkpoint(out_dir, tokenizer_path=tok_path)
    check(enc.device.type == "cuda" and next(enc.model.parameters()).is_cuda,
          "Encoder.from_checkpoint did not take the card by default")
    outs16 = run(enc, "mh_flash_fwd", "int8_flash_fwd")
    enc8 = api.Encoder(enc.model, enc.sp, quantize=True, quantize_attention=True)
    outs8 = run(enc8, "int8_flash_fwd", "mh_flash_fwd")
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    want = _counts(mh_flash_fwd=L * n_batches * len(SERVING_RUNS),
                   int8_flash_fwd=L * n_batches * len(SERVING_RUNS))
    check(launches == want, f"the converted checkpoint's path launched {launches}, want {want}")

    # -- what the path is held against (launches not counted) -----------------
    mem_outs = {key: enc_mem.encode_sequences(seqs, method=key[0], batch_size=bs,
                                              mask_padding=key[1]) for key in SERVING_RUNS}
    same = all(np.array_equal(outs16[key], mem_outs[key]) for key in SERVING_RUNS)
    check(same, "embeddings from the converted directory differ from the in-memory state's")
    with _plain_attention():
        plain = {key: enc.encode_sequences(seqs, method=key[0], batch_size=bs,
                                           mask_padding=key[1]) for key in SERVING_RUNS}
    kernel_fn = port_attention.int8_flash_attention
    port_attention.int8_flash_attention = int8_flash_attention_plain
    try:
        plain8 = {key: enc8.encode_sequences(seqs, method=key[0], batch_size=bs,
                                             mask_padding=key[1]) for key in SERVING_RUNS}
    finally:
        port_attention.int8_flash_attention = kernel_fn
    cos_plain = min(_min_row_cosine(outs16[k], plain[k]) for k in SERVING_RUNS)
    cos_8 = min(_min_row_cosine(outs8[k], outs16[k]) for k in SERVING_RUNS)
    cos_8plain = min(_min_row_cosine(outs8[k], plain8[k]) for k in SERVING_RUNS)
    check(cos_plain >= MIN_COSINE, f"converted: kernel vs plain attention {cos_plain}")
    check(cos_8 >= MIN_COSINE_INT8, f"converted: int8 vs bf16 {cos_8}")
    check(cos_8plain >= MIN_COSINE, f"converted: #9 vs the plain int8 attention {cos_8plain}")
    print(f"converted checkpoint served: {len(SERVING_RUNS)} encode_sequences calls a path, "
          f"launches {launches}; embeddings equal to the in-memory state's bit for bit; min "
          f"row cosine kernel vs plain attention {cos_plain:.7f} (threshold {MIN_COSINE}), "
          f"int8 vs bf16 {cos_8:.6f} ({MIN_COSINE_INT8}), #9 vs plain int8 {cos_8plain:.7f} "
          f"({MIN_COSINE})")
    del enc8, enc_mem, mem, plain, plain8

    # -- the FASTA CLI on the converted directory -----------------------------
    fasta = os.path.join(workdir, "ref_seqs.fa")
    with open(fasta, "w") as f:
        f.writelines(f">s{i}\n{s}\n" for i, s in enumerate(seqs))
    out_npz = os.path.join(workdir, "ref_emb.npz")
    before = dict(_kernels.LAUNCHES)
    check(api.main(["--checkpoint", out_dir, "--fasta", fasta, "--out", out_npz,
                    "--tokenizer-path", tok_path]) == 0, "the FASTA CLI failed")
    with np.load(out_npz) as z:
        ids, emb = list(z["ids"]), z["embeddings"]
    check(ids == [f"s{i}" for i in range(len(seqs))] and emb.shape == (len(seqs), cfg.n_embd)
          and _kernels.LAUNCHES["mh_flash_fwd"] - before["mh_flash_fwd"] == L * n_batches,
          f"the FASTA CLI on the converted directory: {emb.shape}, {_kernels.LAUNCHES}")
    cos_cli = _min_row_cosine(emb, outs16[("mean", True)])
    check(cos_cli >= 0.9999, f"the FASTA CLI vs the Encoder: {cos_cli}")
    print(f"FASTA CLI on the converted directory: {emb.shape[0]} embeddings, min row cosine "
          f"vs Encoder.from_checkpoint {cos_cli:.7f}")

    x = torch.randint(20, 65000, (bs, cfg.block_size),
                      generator=torch.Generator(device="cuda").manual_seed(2101), device="cuda")
    rate = _encode_rate(enc.model, x, "the converted checkpoint")
    beside = ("" if rate16 is None else f", phase 3's random weights {rate16:.1f} seq/s "
              f"({rate / rate16:.4f} x)")
    print(f"encode(mean) B={bs} T={cfg.block_size}: converted checkpoint {rate:.1f} seq/s"
          f"{beside}; {gpu_name_and_power()}")
    del enc, x
    import shutil
    shutil.rmtree(out_dir)
    torch.cuda.empty_cache()
    print(f"phase 21: {time.time() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# 22. the flash and int8 entries at a T that is not a multiple of 128
# ---------------------------------------------------------------------------

RAGGED_T = (192, 320, 1000)
RAGGED_LAYOUTS = ("dense", "packed", "padded")
RAGGED_RATES = (0.0, TRAIN_DROPOUT)
# the backward cases of each call: (name, flash_attention's extra keywords
# as a function of T, the attention switches, the backward kernels it
# launches)
RAGGED_BWD_CASES = (
    ("fused", lambda T: {}, {}, ("mh_flash_bwd",)),
    ("fused multi-kv", lambda T: dict(block_kv=_largest_divisor(T, 128)), {},
     ("mh_flash_bwd_mk",)),
    ("split pair", lambda T: {}, dict(FUSED_SINGLE_KV_BWD=False),
     ("mh_flash_bwd_dkv", "mh_flash_bwd_dq")))
# _ragged_other_checks' calls: one head of 96 (T, dtype); the per-head
# entry at T = 192 (dtype, layout); #9 (T, dtype)
RAGGED_ONE_HEAD = ((192, "bfloat16"), (320, "float32"))
RAGGED_PER_HEAD = tuple((dtype, layout) for dtype in ("bfloat16", "float32")
                        for layout in ("dense", "packed"))
RAGGED_INT8 = tuple((T, dtype) for T in (192, 320) for dtype in ("bfloat16", "float32"))


def _largest_divisor(T, at_most):
    """The largest even divisor of T up to at_most (the dropout stream
    draws 2x2 blocks of a tile)."""
    return max(d for d in range(2, at_most + 1, 2) if T % d == 0)


def _ragged_plain(q, k, v, do, seg, rope, kw):
    """The plain versions at the unpadded T: (o, dq, dk, dv); the forward
    on kv tiles of the largest divisor of T up to the kernel's."""
    from omnibiote_tpu_torch.ops import flash_attention as fa

    T, D = q.shape[1], q.shape[3]
    block = _largest_divisor(T, fa.kernel_kv_tile(q.dtype, fa.padded_head_dim(D)))
    o, lse2 = fa.mh_flash_forward_plain(q, k, v, seg, rope, block_kv=block, **kw)
    di = (o.float() * do.float()).sum(-1)
    return (o, *fa.mh_flash_backward_plain(q, k, v, do, lse2, di, seg, rope, **kw))


def _ragged_entry(q, k, v, do, seg, rope, kw, **extra):
    """flash_attention on CUDA tensors: o and the q, k, v gradients."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa

    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    o = fa.flash_attention(q, k, v, seg, rope, **kw, **extra)
    return (o.detach(), *torch.autograd.grad(o, (q, k, v), do))


def _hold_ragged(got, want, dtype, what):
    """o at TOL's o and the gradients at BWD_TOL (phase 2's tolerances);
    returns (max |do|, max |d|)."""
    import torch
    rt, at = TOL[dtype]["o"]
    check(got[0].shape == want[0].shape and got[0].dtype == want[0].dtype
          and torch.allclose(got[0].float(), want[0].float(), rtol=rt, atol=at),
          f"the forward disagrees with its plain version at {what}: max|do| "
          f"{_abs_err(got[0], want[0]):.3e}")
    return _abs_err(got[0], want[0]), _hold_bwd(got[1:], want[1:], dtype, what)[1]


def _ragged_flash_checks(H, D, dtypes, layouts=RAGGED_LAYOUTS, seed=2200):
    """#1-#5 through flash_attention at every RAGGED_T, B 2, H heads of D
    with RoPE, dropout 0 and 0.1: the forward and each of RAGGED_BWD_CASES,
    the fused backward with one kv block (#2) and with kv blocks below T
    (#3), and the split pair (#4/#5), against the plain versions at the
    unpadded T (the same seed draws the same mask there), and a second
    forward launch bit for bit. Returns (the worst bf16 errors, the
    launches its loops make: 4 forwards and one of each backward case a
    call)."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa

    worst = {"fwd": 0.0, "bwd": 0.0}
    for T in RAGGED_T:
        for dtype in dtypes:
            for j, layout in enumerate(layouts):
                for rate in RAGGED_RATES:
                    s = seed + 10 * T + j + int(100 * rate)
                    q, k, v, seg, rope = _attn_inputs(2, T, H, D, getattr(torch, dtype),
                                                      layout, s)
                    do = torch.randn(q.shape, device="cuda",
                                     generator=torch.Generator(device="cuda").manual_seed(s)
                                     ).to(q.dtype)
                    kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=rate, seed=s)
                    want = _ragged_plain(q, k, v, do, seg, rope, kw)
                    tag = f"T={T} H={H} D={D} {dtype} {layout} dropout {rate}"
                    for case, extra, switch, _ in RAGGED_BWD_CASES:
                        with _attention_switch(**switch):
                            got = _ragged_entry(q, k, v, do, seg, rope, kw, **extra(T))
                        err = _hold_ragged(got, want, dtype, f"{tag}, {case}")
                        if dtype == "bfloat16":
                            worst = {"fwd": max(worst["fwd"], err[0]),
                                     "bwd": max(worst["bwd"], err[1])}
                    with torch.no_grad():
                        again = fa.flash_attention(q, k, v, seg, rope, **kw)
                    check(torch.equal(again, got[0]), f"{tag}: a second forward launch differs")
    n = len(RAGGED_T) * len(dtypes) * len(layouts) * len(RAGGED_RATES)
    want = {"mh_flash_fwd": (len(RAGGED_BWD_CASES) + 1) * n}
    want.update((name, n) for *_, names in RAGGED_BWD_CASES for name in names)
    return worst, want


def _ragged_other_checks():
    """One head at D = 96 (head dim and T padded together), the per-head
    entry at T = 192, and #9 at T = 192 and 320, each against its plain
    version at the unpadded T. Returns the launches its loops make: a
    forward and a fused backward (#1, #2) of each one-head call, #6-#8 of
    each per-head call, #9 of each int8 call."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops import int8_attention as i8

    for i, (T, dtype) in enumerate(RAGGED_ONE_HEAD):
        q, k, v, seg, rope = _attn_inputs(2, T, 1, 96, getattr(torch, dtype), "packed", 2300 + i)
        do = torch.randn_like(q.float()).to(q.dtype)
        kw = dict(scale=1.0 / math.sqrt(96), dropout_rate=TRAIN_DROPOUT, seed=2300 + i)
        _hold_ragged(_ragged_entry(q, k, v, do, seg, rope, kw),
                     _ragged_plain(q, k, v, do, seg, rope, kw), dtype,
                     f"one head of 96 at T={T} {dtype}")
    for dtype, layout in RAGGED_PER_HEAD:
        i = ("bfloat16", "float32").index(dtype)
        q, k, v, seg, _ = _attn_inputs(2, 192, 8, 128, getattr(torch, dtype), layout, 2310 + i)
        do = torch.randn_like(q.float()).to(q.dtype)
        kw = dict(scale=1.0 / math.sqrt(128), dropout_rate=TRAIN_DROPOUT, seed=2310 + i)
        _hold_ragged(_ragged_entry(q, k, v, do, seg, None, kw, multi_head=False),
                     _ragged_plain(q, k, v, do, seg, None, kw), dtype,
                     f"the per-head entry at T=192 {dtype} {layout}")
    worst8 = 1.0
    for T, dtype in RAGGED_INT8:
        for j, layout in enumerate(RAGGED_LAYOUTS):
            q, k, v, seg, rope = _attn_inputs(2, T, 8, 128, getattr(torch, dtype), layout,
                                              2320 + T + j)
            kw = dict(scale=1.0 / math.sqrt(128), segment_ids=seg, rope=rope)
            o = i8.int8_flash_attention(q, k, v, **kw)
            po = i8.int8_flash_attention_plain(q, k, v, **kw)
            rt, at = INT8_TOL[dtype]
            check(o.shape == q.shape and o.dtype == q.dtype
                  and torch.allclose(o.float(), po.float(), rtol=rt, atol=at),
                  f"#9 at T={T} {dtype} {layout}: max|do| {_abs_err(o, po):.3e}")
            cos = torch.nn.functional.cosine_similarity(
                o.float().reshape(-1, 128).double(), po.float().reshape(-1, 128).double(),
                dim=1).min().item()
            check(cos >= MIN_COSINE, f"#9 at T={T} {dtype} {layout}: min row cosine {cos}")
            worst8 = min(worst8, cos)
    print(f"ragged T: one head of 96 (T 192, 320), the per-head entry at T=192 (bf16, fp32, "
          f"dense, packed, dropout {TRAIN_DROPOUT}) within phase 2's tolerances; #9 at T 192 "
          f"and 320 (bf16, fp32, {', '.join(RAGGED_LAYOUTS)}, RoPE) min row cosine vs plain "
          f"{worst8:.7f}")
    n_head, n_int8 = len(RAGGED_PER_HEAD), len(RAGGED_INT8) * len(RAGGED_LAYOUTS)
    return {"mh_flash_fwd": len(RAGGED_ONE_HEAD), "mh_flash_bwd": len(RAGGED_ONE_HEAD),
            "flash_fwd": n_head, "flash_bwd_dkv": n_head, "flash_bwd_dq": n_head,
            "int8_flash_fwd": n_int8}


# the port's own kernels (ops/csrc) by the names the profiler reports
PORT_KERNEL_NAME = re.compile(
    r"\b(mh_\w+|int8_fwd\w*|quant_qk\w*|quant_v\w*|dq_epilogue\w*|rope_rows\w*)")


def _call_ms(fn, n=10):
    """Of one call of fn: (its device time, every kernel's, from the
    profiler; {the port's kernel: its device time}; ms by CUDA events over
    back-to-back calls, the host's launches included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    events_ms = cuda_ms(fn, n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy, own = 0.0, {}
    for e in prof.events():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = e.time_range.elapsed_us()
        busy += us
        m = PORT_KERNEL_NAME.search(e.name)
        if m:
            own[m.group(1)] = own.get(m.group(1), 0.0) + us / 1e3 / n
    check(own, "the profiler saw none of the port's kernels")
    return busy / 1e3 / n, own, events_ms


def _host_ms(fn, n=20):
    """The host's time to issue one call of fn, in ms: n calls queued back
    to back after a sync, timed on the host's clock without waiting for the
    card (whose share of these calls is smaller than the host's)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    return host


def _host_ops(fn, n=10, top=6):
    """The `top` operators of one call of fn by their own time on the
    host (the profiler's self CPU time), ms a call each."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:top]
    return [(e.key, e.self_cpu_time_total / 1e3 / n, e.count / n) for e in ops]


def _int8_rows_probe(T, seg, rope):
    """#9's kernels at B 16, 8 heads of 128, bf16, on 256 rows of several
    contents with the same padded ids and tables: 256 random rows; the same
    with the last 256 - T rows zeroed in place, and set to 1 in place; T
    random rows padded ahead by pad_rows; a contiguous copy of those; the
    256 random rows again. {variant: {kernel: device ms}} by the
    profiler."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops import int8_attention as i8

    Tp = fa.padded_seq_len(T, i8.KERNEL_T_MULTIPLE)
    segp, ropep = fa.pad_segment_ids(seg, 16, T, Tp), fa.pad_rope_rows(rope, T, Tp)
    rand = _attn_inputs(16, Tp, 8, 128, torch.bfloat16, "dense", 2403)[:3]
    zeroed, ones = tuple(x.clone() for x in rand), tuple(x.clone() for x in rand)
    for x, y in zip(zeroed, ones):
        x[:, T:], y[:, T:] = 0, 1
    ahead = tuple(fa.pad_rows(x[:, :T].contiguous(), Tp)
                  for x in _attn_inputs(16, T, 8, 128, torch.bfloat16, "dense", 2404)[:3])
    variants = (("random", rand), ("random, rows past T zeroed", zeroed),
                ("random, rows past T set to 1", ones), ("padded ahead", ahead), ("padded ahead, copied", tuple(x.clone() for x in ahead)),
                ("random again", rand))
    out = {}
    with torch.no_grad():
        for name, (q, k, v) in variants:
            out[name] = _call_ms(lambda: i8.int8_flash_attention(
                q, k, v, scale=1.0 / math.sqrt(128), segment_ids=segp, rope=ropep))[1]
    return out


def _ragged_timings():
    """The entries at T = 192 (rows padded to 256) beside T = 256, B 16, 8
    heads of 128, bf16, packed rows (~3 segment starts a row): #1 (RoPE,
    no dropout), #2 and the split pair #4 + #5 (RoPE, dropout 0.1; a
    backward is forward + backward less the forward), the per-head #6 and
    #7 + #8 (no RoPE, dropout 0.1), and #9 (RoPE). Each: the device time a
    call, each of the port's kernels' in it, and CUDA events over
    back-to-back calls; and of the forwards, the host's time to issue a
    call (`_host_ms`), at T = 192 split into the padding's pieces and the
    call on padded rows, with the operators that take the host's time.
    Then #9's kernels on rows of several contents (`_int8_rows_probe`)."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops import int8_attention as i8

    out, host = {}, {}
    for T in (256, 192):
        q, k, v, _, rope = _attn_inputs(16, T, 8, 128, torch.bfloat16, "dense", 2400)
        gen = torch.Generator(device="cuda").manual_seed(2401)
        seg = torch.cumsum((torch.rand(16, T, generator=gen, device="cuda") < 3 / T).int(),
                           1).int().contiguous()
        do = torch.randn(q.shape, device="cuda", generator=gen).bfloat16()
        qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
        scale = 1.0 / math.sqrt(128)
        drop = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=2402)

        def fwd(**kw):
            with torch.no_grad():
                return _call_ms(lambda: fa.flash_attention(q, k, v, seg, **kw))

        def bwd(f, **kw):
            fb = _call_ms(lambda: torch.autograd.grad(fa.flash_attention(qg, kg, vg, seg, **kw),
                                                      (qg, kg, vg), do))
            own = {n: t - f[1].get(n, 0.0) for n, t in fb[1].items()}
            return fb[0] - f[0], {n: t for n, t in own.items() if t > 1e-4}, fb[2] - f[2]

        out[("#1", T)] = fwd(rope=rope, scale=scale)
        f_drop = fwd(rope=rope, **drop)
        out[("#2", T)] = bwd(f_drop, rope=rope, **drop)
        with _attention_switch(FUSED_SINGLE_KV_BWD=False):
            out[("#4+#5", T)] = bwd(f_drop, rope=rope, **drop)
        out[("#6", T)] = fwd(rope=None, multi_head=False, **drop)
        out[("#7+#8", T)] = bwd(out[("#6", T)], rope=None, multi_head=False, **drop)
        with torch.no_grad():
            out[("#9", T)] = _call_ms(lambda: i8.int8_flash_attention(
                q, k, v, scale=scale, segment_ids=seg, rope=rope))
            entries = {
                "#1": lambda: fa.flash_attention(q, k, v, seg, rope, scale=scale),
                "#6": lambda: fa.flash_attention(q, k, v, seg, multi_head=False, **drop),
                "#9": lambda: i8.int8_flash_attention(q, k, v, scale=scale, segment_ids=seg,
                                                      rope=rope)}
            for name, fn in entries.items():
                host[(name, T)] = _host_ms(fn)
            if T % 128:
                Tp = fa.padded_seq_len(T, 128)
                qp, kp, vp = (fa.pad_rows(x, Tp) for x in (q, k, v))
                segp = fa.pad_segment_ids(seg, 16, T, Tp)
                op = fa.flash_attention(qp, kp, vp, segp, multi_head=False, **drop)
                host["#6 pieces"] = {
                    "pad q, k, v": _host_ms(lambda: [fa.pad_rows(x, Tp) for x in (q, k, v)]),
                    "pad ids": _host_ms(lambda: fa.pad_segment_ids(seg, 16, T, Tp)),
                    "call on padded rows": _host_ms(lambda: fa.flash_attention(
                        qp, kp, vp, segp, multi_head=False, **drop)),
                    "slice": _host_ms(lambda: op[:, :T].contiguous())}
                host["#6 ops"] = _host_ops(entries["#6"])
                host["#1 ops"] = _host_ops(entries["#1"])
                del op
            if T % 128:
                # the same calls on rows padded ahead: the kernels alone at
                # the padded T, without the padding's own passes
                Tp = fa.padded_seq_len(T, 128)
                qp, kp, vp = (fa.pad_rows(x, Tp) for x in (q, k, v))
                segp = fa.pad_segment_ids(seg, 16, T, Tp)
                ropep = fa.pad_rope_rows(rope, T, Tp)
                out[("#1 padded ahead", T)] = _call_ms(
                    lambda: fa.flash_attention(qp, kp, vp, segp, ropep, scale=scale))
                out[("#9 padded ahead", T)] = _call_ms(lambda: i8.int8_flash_attention(
                    qp, kp, vp, scale=scale, segment_ids=segp, rope=ropep))
                del qp, kp, vp
        del q, k, v, qg, kg, vg, do
    torch.cuda.empty_cache()
    print(f"ragged T timings, B=16, 8 heads of 128, bf16, packed; ms a call at T=192 (rows "
          f"padded to 256) / T=256: each of the port's kernels and the whole call on the "
          f"device (profiler), and CUDA events over back-to-back calls (a backward: forward "
          f"+ backward less the forward); {gpu_name_and_power()}")
    for name in ("#1", "#2", "#4+#5", "#6", "#7+#8", "#9"):
        a, b = out[(name, 192)], out[(name, 256)]
        kernels = ", ".join(f"{k} {a[1].get(k, 0.0):.4f} / {b[1].get(k, 0.0):.4f}"
                            for k in sorted(set(a[1]) | set(b[1])))
        print(f"  {name}: {kernels}; device {a[0]:.4f} / {b[0]:.4f}; events "
              f"{a[2]:.4f} / {b[2]:.4f}")
    for name in ("#1", "#9"):
        a = out[(name + " padded ahead", 192)]
        kernels = ", ".join(f"{k} {t:.4f}" for k, t in sorted(a[1].items()))
        print(f"  {name} on rows padded ahead (T=192 as 256, the padding's passes outside the "
              f"call): {kernels}; device {a[0]:.4f}; events {a[2]:.4f}")
    print("  host ms to issue a call (no wait for the card), T=192 / T=256: "
          + ", ".join(f"{n} {host[(n, 192)]:.4f} / {host[(n, 256)]:.4f}"
                      for n in ("#1", "#6", "#9")))
    print("  #6 at T=192, host ms a piece: " + ", ".join(
        f"{n} {t:.4f}" for n, t in host["#6 pieces"].items()))
    for name in ("#6", "#1"):
        print(f"  {name} at T=192, the host's operators by their own time (ms a call, calls a "
              f"call): " + "; ".join(f"{k} {t:.4f} x{c:g}" for k, t, c in host[name + " ops"]))
    _, _, _, seg, rope = _attn_inputs(16, 192, 8, 128, torch.bfloat16, "packed", 2405)
    probe = _int8_rows_probe(192, seg, rope)
    print("  #9's kernels on 256 rows, the same padded ids and tables (ms a call, profiler): "
          + "; ".join(f"{name}: " + ", ".join(f"{k} {t:.4f}" for k, t in sorted(ks.items()))
                      for name, ks in probe.items()))
    return out


def _ragged_no_sync_check():
    """One padded call of each entry at T = 192 with packed ids (the id
    renumbering runs), bf16, 8 heads of 128, under
    torch.cuda.set_sync_debug_mode("error"): flash_attention with RoPE and
    dropout, forward and backward, the per-head entry, forward and
    backward, and int8_flash_attention. A host sync in the padding or in
    the kernels' own path raises."""
    import torch
    from omnibiote_tpu_torch.ops import int8_attention as i8

    q, k, v, seg, rope = _attn_inputs(2, 192, 8, 128, torch.bfloat16, "packed", 2450)
    do = torch.randn_like(q.float()).bfloat16()
    kw = dict(scale=1.0 / math.sqrt(128), dropout_rate=TRAIN_DROPOUT, seed=2451)
    calls = {
        "flash_attention": lambda: _ragged_entry(q, k, v, do, seg, rope, kw),
        "flash_attention(multi_head=False)":
            lambda: _ragged_entry(q, k, v, do, seg, None, kw, multi_head=False),
        "int8_flash_attention": lambda: i8.int8_flash_attention(
            q, k, v, scale=kw["scale"], segment_ids=seg, rope=rope)}
    for name, fn in calls.items():
        fn()        # first: any one-off set-up outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            check(False, f"a padded {name} call synchronised with the host: {e}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    print(f"ragged T: one padded call of each of {', '.join(calls)} at T=192 (packed ids) ran "
          f"under torch.cuda.set_sync_debug_mode('error'): no host sync")


def ragged_t_phase():
    """Phase 22: flash_attention and int8_flash_attention called directly
    at T 192, 320 and 1000 on CUDA tensors, which pad the rows to the
    kernels' T multiple: 8 heads of 128 (bf16, fp32) and 2 heads of 512
    (bf16, the cluster backwards), one head of 96, the per-head entry, #9.
    One padded call of each entry runs with host syncs made errors. (Its
    timings, `_ragged_timings`, run early in main: after the multi-GPU
    phases the profiler of this process recorded no kernels.)
    Returns (the launches of the 128-wide calls (one head of 96 among
    them), those of the 512-wide calls, the worst bf16 errors)."""
    import torch
    from omnibiote_tpu_torch.ops import _kernels

    t0 = time.time()
    _kernels.reset_launches()
    worst, want512 = _ragged_flash_checks(WIDER_HEADS, WIDER_D, ("bfloat16",), seed=2500)
    torch.cuda.synchronize()
    launches512 = dict(_kernels.LAUNCHES)
    _kernels.reset_launches()
    w128, want128 = _ragged_flash_checks(8, 128, ("bfloat16", "float32"))
    for name, n in _ragged_other_checks().items():
        want128[name] = want128.get(name, 0) + n
    torch.cuda.synchronize()
    launches128 = dict(_kernels.LAUNCHES)
    worst = {n: max(worst[n], w128[n]) for n in worst}
    # each call launched exactly its kernels: every case took its own
    # kernel (a multi-kv case the multi-kv kernel, a split-pair case the
    # pair), and no wrapper counted twice
    want128, want512 = _counts(**want128), _counts(**want512)
    check(launches128 == want128 and launches512 == want512,
          f"the ragged-T calls launched 128 {launches128}, want {want128}; 512 "
          f"{launches512}, want {want512}")
    _ragged_no_sync_check()
    print(f"ragged T ({', '.join(map(str, RAGGED_T))}; {', '.join(RAGGED_LAYOUTS)}; dropout 0 and "
          f"{TRAIN_DROPOUT}): every call within phase 2's tolerances of the plain version at "
          f"the unpadded T; worst bf16 max|do| {worst['fwd']:.3e}, max|d| {worst['bwd']:.3e}; "
          f"launches at 8 x 128 (and one head of 96) {launches128}, at 2 x 512 {launches512}")
    print(f"phase 22: {time.time() - t0:.1f} s")
    return launches128, launches512, worst


# ---------------------------------------------------------------------------
# 23. the fp32 path at omnibiote-small width
# ---------------------------------------------------------------------------

# fp32 compute against the plain attention (dropout 0, the same weights,
# batch and seeds): only the order of fp32 sums differs, so the loss is held
# to 1e-4, every gradient to a cosine of 0.9999, grad_norm to 1e-4 relative,
# and each embedding row to a cosine of 0.99999.
F32_LOSS_ATOL = 1e-4
F32_GRAD_COS = 0.9999
F32_GNORM_RTOL = 1e-4
F32_MIN_COSINE = 0.99999
# what a console-script wrapper runs (pyproject.toml [project.scripts])
CONSOLE_WRAPPER = "import sys\nfrom {module} import main\nsys.exit(main())\n"


def _console_script(module, argv):
    """Start `module`'s console script in a subprocess, as the wrapper that
    pip installs runs it, on this checkout's package."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", CONSOLE_WRAPPER.format(module=module), *argv],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=env, cwd=ROOT)


def _wait_script(proc, name, timeout=600):
    out = proc.communicate(timeout=timeout)[0]
    check(proc.returncode == 0, f"{name} exited {proc.returncode}:\n{out[-4000:]}")
    return out


def _f32_rebuilt_checks():
    """The 3xTF32 fp32 kernels (#1/#6 `mh_fwd_f32`; #2/#3 `mh_bwd_f32` and
    #4/#7 its instance without dq; #5/#8 `mh_bwd_dq_f32`) against their
    plain versions at TOL / BWD_TOL, at D = 64, 128 and 256 (heads of D,
    B=2, T=256), dense, packed and padded rows, dropout 0 and 0.1, RoPE or
    none: a second forward and dq launch the same bits, the forward, the
    dkv and the dq kernel with skipping the same bits as over every tile,
    the fused kernel's dk and dv the dkv kernel's bits and within its
    tolerance with skipping. Returns the worst (max |do|, max |d| /
    max |g|)."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa

    f32, B, T, H = torch.float32, 2, 256, 2
    worst_o = worst_g = 0.0
    n = 0
    for D in (64, 128, 256):
        for layout in ("dense", "packed", "padded"):
            for rate in (0.0, TRAIN_DROPOUT):
                for rope_on in (True, False):
                    seed = 3000 + 10 * D + 4 * len(layout) + 2 * int(rate > 0) + rope_on
                    q, k, v, seg, rope = _attn_inputs(B, T, H, D, f32, layout, seed)
                    rope = rope if rope_on else None
                    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
                    do = torch.randn(B, T, H, D, generator=gen, device="cuda")
                    kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=rate, seed=seed + 7)
                    what = f"fp32 D={D} {layout} dropout {rate} RoPE {rope_on}"
                    o, lse = fa.mh_flash_forward(q, k, v, seg, rope, **kw)
                    worst_o = max(worst_o, _hold_fwd((o, lse), fa.mh_flash_forward_plain(
                        q, k, v, seg, rope, **kw, block_kv=fa.kernel_kv_tile(f32, D)),
                        "float32", what))
                    again = fa.mh_flash_forward(q, k, v, seg, rope, **kw)
                    check(torch.equal(o, again[0]) and torch.equal(lse, again[1]),
                          f"a second forward launch gave other bits at {what}")
                    args = (q, k, v, do, lse, (o * do).sum(-1), seg, rope)
                    want = fa.mh_flash_backward_plain(*args, **kw)
                    fused = fa.mh_flash_backward(*args, **kw)
                    dkv = fa.mh_flash_bwd_dkv(*args, **kw)
                    worst_g = max(worst_g, _hold_bwd(fused, want, "float32", what)[0],
                                  _hold_bwd(dkv, want[1:], "float32", what + " dkv")[0])
                    check(torch.equal(fused[1], dkv[0]) and torch.equal(fused[2], dkv[1]),
                          f"the fused kernel's dk, dv are not the dkv kernel's at {what}")
                    dq = fa.mh_flash_bwd_dq(*args, **kw)
                    worst_g = max(worst_g, _hold_bwd((dq,), (fa.mh_flash_bwd_dq_plain(
                        *args, **kw),), "float32", what + " dq")[0])
                    check(torch.equal(dq, fa.mh_flash_bwd_dq(*args, **kw)),
                          f"a second dq launch gave other bits at {what}")
                    if seg is not None:
                        skip = dict(segment_skip=True, bounds=fa.SegmentBounds(seg))
                        on = fa.mh_flash_forward(q, k, v, seg, rope, **kw, **skip)
                        check(torch.equal(on[0], o) and torch.equal(on[1], lse),
                              f"forward skipping on != off at {what}")
                        on = fa.mh_flash_bwd_dkv(*args, **kw, **skip)
                        check(torch.equal(on[0], dkv[0]) and torch.equal(on[1], dkv[1]),
                              f"dkv skipping on != off at {what}")
                        check(torch.equal(fa.mh_flash_bwd_dq(*args, **kw, **skip), dq),
                              f"dq skipping on != off at {what}")
                        _hold_bwd(fa.mh_flash_backward(*args, **kw, **skip), want, "float32",
                                  what + " skipping")
                    n += 1
    print(f"fp32 3xTF32 kernels (#1/#6, #2/#3, #4/#7, #5/#8) vs plain: {n} cases (D 64/128/256 x 3 "
          f"layouts x dropout x RoPE), worst max|do| {worst_o:.3e}, worst max|d| / max|g| "
          f"{worst_g:.3e}; second launch and skipping on = off the same bits")
    _f32_nan_checks()
    torch.cuda.empty_cache()
    return worst_o, worst_g


def _hold_nans(got, want, rtol, atol, what):
    """NaN in got exactly where want has it (and somewhere), the rest
    within (rtol, atol)."""
    import torch
    nan = torch.isnan(want)
    check(torch.equal(torch.isnan(got), nan) and bool(nan.any()),
          f"{what}: {int(torch.isnan(got).sum())} NaNs from the kernel, "
          f"{int(nan.sum())} from the plain version, not in the same places")
    check(torch.allclose(got[~nan], want[~nan], rtol=rtol, atol=atol),
          f"{what}: the finite values disagree with the plain version")


def _f32_nan_checks():
    """The NaN that CUDA arithmetic makes (0x7fffffff) in one element of q
    and one of v (dense, dropout 0, D = 64, 128 and 256, RoPE or none): the
    3xTF32 kernels' o, lse2, dq, dk and dv (the fused kernel's, the dkv
    kernel's and the dq kernel's) hold NaN exactly where the plain versions
    do, and agree with them elsewhere at TOL / BWD_TOL."""
    import torch
    from omnibiote_tpu_torch.ops import flash_attention as fa

    f32, B, T, H = torch.float32, 2, 256, 2
    (rt, at), (rl, al) = TOL["float32"]["o"], TOL["float32"]["lse"]
    n = 0
    for D in (64, 128, 256):
        for rope_on in (True, False):
            seed = 3500 + D + rope_on
            q, k, v, _, rope = _attn_inputs(B, T, H, D, f32, "dense", seed)
            rope = rope if rope_on else None
            q, v = q.contiguous().clone(), v.contiguous().clone()
            q.view(torch.int32)[0, 37, 0, 5] = 0x7FFFFFFF
            v.view(torch.int32)[1, 90, 1, 3] = 0x7FFFFFFF
            gen = torch.Generator(device="cuda").manual_seed(seed + 1)
            do = torch.randn(B, T, H, D, generator=gen, device="cuda")
            kw = dict(scale=1.0 / math.sqrt(D), dropout_rate=0.0, seed=seed)
            what = f"fp32 D={D} dense RoPE {rope_on}, a NaN in q and in v"
            o, lse = fa.mh_flash_forward(q, k, v, None, rope, **kw)
            po, plse = fa.mh_flash_forward_plain(q, k, v, None, rope, **kw,
                                                 block_kv=fa.kernel_kv_tile(f32, D))
            _hold_nans(o, po, rt, at, what + ": o")
            _hold_nans(lse, plse, rl, al, what + ": lse")
            args = (q, k, v, do, lse, (o * do).sum(-1), None, rope)
            want = fa.mh_flash_backward_plain(*args, **kw)
            got = (*fa.mh_flash_backward(*args, **kw), *fa.mh_flash_bwd_dkv(*args, **kw),
                   fa.mh_flash_bwd_dq(*args, **kw))
            for name, g, w in zip(("dq", "dk", "dv", "dkv's dk", "dkv's dv", "dq kernel's dq"),
                                  got, (*want, *want[1:], fa.mh_flash_bwd_dq_plain(*args, **kw))):
                finite = w[~torch.isnan(w)]  # empty where every gradient is a NaN
                scale_g = finite.abs().max().item() if finite.numel() else 0.0
                _hold_nans(g, w, 0.0, BWD_TOL["float32"] * scale_g, f"{what}: {name}")
            n += 1
    print(f"fp32 3xTF32 kernels with a NaN (0x7fffffff) in q and in v: {n} cases (D 64/128/256 "
          f"x RoPE), NaN in o, lse, dq, dk, dv where the plain versions have it")


def _f32_timings():
    """Each fp32 kernel instance (#1-#9) at its row's shape of the kernel
    table: #1 and #2 at B=16, T=1024 (bench.py's rows, 3 EOS), #3-#5 at
    B=8, T=2048 (5 EOS), both with RoPE and dropout 0.1, with skipping and
    over every tile; #6-#8, the per-head entry, at B=16, T=1024 (no RoPE;
    it walks every tile), after its own path's launches; #9 at B=32,
    T=1024, dense. Each beside its plain version, its bound and SDPA on the
    same fp32 inputs. The bound of a kernel that runs 3xTF32 (#1-#8) is
    three TF32 products for each of the function's (or its fp32 bytes),
    with the FFMA bound at the FP32 rate beside it (`bound_ffma_ms`); that
    of #9 (an fp32 quantising prologue, then s8 products) is the FP32 one.
    Returns (rows of the kernels line by kernel name, launches of the
    per-head path)."""
    import torch
    import torch.nn.functional as F
    from omnibiote_tpu_torch.models.rope import apply_rope_half
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import flash_attention as fa
    from omnibiote_tpu_torch.ops import int8_attention as i8

    H, D, f32 = 8, 128, torch.float32
    scale = 1.0 / math.sqrt(D)
    bound_kw = dict(itemsize=4, peak=PEAK_F32_FLOPS)
    # the 3xTF32 kernels' own bound: three TF32 products for each of the
    # function's
    tf32_kw = dict(itemsize=4, peak=PEAK_TF32_FLOPS / 3)
    rows = {}
    print(f"fp32 kernel times: SDPA with torch.backends.cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}")

    def row(name, source, line, ms, ms_all, plain, bound, bound_all, lib, err, ffma=None):
        """ffma: the FFMA bounds (visible, all pairs) of a 3xTF32 kernel,
        whose own bounds are bound and bound_all"""
        print(f"  {name} fp32: {ms:.4f} ms" + ("" if ms_all is None else
              f" with skipping, {ms_all:.4f} over every tile") + f"; plain {plain:.4f} ms; "
              + ("3xTF32 " if ffma else "") + f"bound {bound[0]:.4f} ms ({bound[1]}) over "
              f"visible pairs, {bound_all[0]:.4f} over all; "
              + (f"FFMA bound {ffma[0][0]:.4f} / {ffma[1][0]:.4f}; " if ffma else "")
              + ("no library call" if lib is None else f"SDPA {lib:.4f} ms")
              + f"; max|d| {err:.3e}")
        rows[name] = {"name": f"{name} fp32", "route": "cuda",
                      "source": f"omnibiote_tpu_torch/ops/csrc/{source}", "replaces": line,
                      "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "bound_ms": bound[0], "bound_by": bound[1], "library_ms": lib}
        if ffma:
            rows[name]["bound_ffma_ms"] = ffma[0][0]

    for B, T, n_eos in ((TRAIN_SHAPE["B"], 1024, 3), (LONG_SHAPES[0][0], 2048, LONG_EOS)):
        q, k, v, _, rope = _attn_inputs(B, T, H, D, f32, "dense", 2600 + T)
        seg = _wide_ids("packed", B, T, n_eos, 2600 + T)
        gen = torch.Generator(device="cuda").manual_seed(2700 + T)
        do = torch.randn(B, T, H, D, generator=gen, device="cuda")
        sb = fa.SegmentBounds(seg)
        kw = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=2564)
        skip = dict(segment_skip=True, bounds=sb)
        o, lse = fa.mh_flash_forward(q, k, v, seg, rope, **kw, **skip)
        args = (q, k, v, do, lse, (o * do).sum(-1), seg, rope)
        pairs = _visible_pairs(seg, B, T)
        qr, kr = apply_rope_half(q, k, *rope)
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_() for x in (qr, kr, v))
        doh = do.transpose(1, 2).contiguous()
        lib_f, alone = _sdpa(qh.detach(), kh.detach(), vh.detach(), dropout_p=TRAIN_DROPOUT,
                             scale=scale)
        lib_b = cuda_ms(lambda: torch.autograd.grad(F.scaled_dot_product_attention(
            qh, kh, vh, dropout_p=TRAIN_DROPOUT, scale=scale), (qh, kh, vh), doh), 5) - lib_f
        print(f" B={B} T={T} H={H} D={D} fp32, {n_eos} EOS a row (visible share of pairs "
              f"{pairs / (B * T * T):.4f}), dropout {TRAIN_DROPOUT}: SDPA dense forward "
              f"{lib_f:.4f} ms (backends alone: "
              f"{', '.join(f'{n} {t:.4f}' for n, t in alone.items()) or 'none'}), backward "
              f"{lib_b:.4f} ms")
        del qr, kr, qh, kh, vh, doh
        want = fa.mh_flash_backward_plain(*args, **kw)
        if T == 1024:
            err = _hold_fwd((o, lse), fa.mh_flash_forward_plain(
                q, k, v, seg, rope, block_kv=fa.kernel_kv_tile(f32, D), **kw), "float32",
                f"fp32 B={B} T={T}")
            row("mh_flash_fwd", "mh_flash_fwd.cu", "omnibiote_tpu/ops/flash_attention.py:545",
                cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, rope, **kw, **skip), 10),
                cuda_ms(lambda: fa.mh_flash_forward(q, k, v, seg, rope, **kw), 10),
                cuda_ms(lambda: fa.mh_flash_forward_plain(q, k, v, seg, rope, **kw), 2,
                        warmup=1),
                _attn_bound(B, T, H, D, pairs, **tf32_kw), _attn_bound(B, T, H, D, None,
                                                                       **tf32_kw),
                lib_f, err, (_attn_bound(B, T, H, D, pairs, **bound_kw),
                             _attn_bound(B, T, H, D, None, **bound_kw)))
            kinds = (("mh_flash_bwd", "fused", fa.mh_flash_backward, fa.mh_flash_backward_plain,
                      "mh_flash_bwd.cu", 965, lib_b, want),)
        else:
            kinds = (("mh_flash_bwd_mk", "fused", fa.mh_flash_backward,
                      fa.mh_flash_backward_plain, "mh_flash_bwd.cu", 1128, lib_b, want),
                     ("mh_flash_bwd_dkv", "dkv", fa.mh_flash_bwd_dkv, fa.mh_flash_bwd_dkv_plain,
                      "mh_flash_bwd_dkv.cu", 773, None, want[1:]),
                     ("mh_flash_bwd_dq", "dq", fa.mh_flash_bwd_dq, fa.mh_flash_bwd_dq_plain,
                      "mh_flash_bwd_dq.cu", 866, None, want[:1]))
            # the split pair's dq: the same bits from a second launch, and
            # with skipping as over every tile
            dq1 = fa.mh_flash_bwd_dq(*args, **kw, **skip)
            check(torch.equal(dq1, fa.mh_flash_bwd_dq(*args, **kw, **skip))
                  and torch.equal(dq1, fa.mh_flash_bwd_dq(*args, **kw)),
                  "the fp32 dq kernel: a second launch, or every tile, gave other bits")
            print(f"  mh_flash_bwd_dq fp32 at B={B} T={T}: a second launch and the walk over "
                  f"every tile the same bits")
            del dq1
        for name, kind, fn, pfn, source, line, lib, w in kinds:
            got = fn(*args, **kw, **skip)
            err = _hold_bwd(got if kind != "dq" else (got,), w, "float32",
                            f"fp32 {name} B={B} T={T}")[1]
            ffma = (_bwd_bound(B, T, H, D, pairs, kind, **bound_kw),
                    _bwd_bound(B, T, H, D, None, kind, **bound_kw))
            tf32 = (_bwd_bound(B, T, H, D, pairs, kind, **tf32_kw),
                    _bwd_bound(B, T, H, D, None, kind, **tf32_kw))
            row(name, source, f"omnibiote_tpu/ops/flash_attention.py:{line}",
                cuda_ms(lambda: fn(*args, **kw, **skip), 10), cuda_ms(lambda: fn(*args, **kw), 10),
                cuda_ms(lambda: pfn(*args, **kw), 2, warmup=1), *tf32, lib, err, ffma)
            del got
        if T == 1024:
            # the per-head entry (#6-#8): its path's launches, then each kernel
            kwh = dict(scale=scale, dropout_rate=TRAIN_DROPOUT, seed=2565)

            def fwd_bwd():
                qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
                out = fa.flash_attention(qg, kg, vg, seg, None, scale=scale, block_q=512,
                                         block_kv=512, multi_head=False,
                                         dropout_rate=TRAIN_DROPOUT, seed=2565)
                return torch.autograd.grad(out, (qg, kg, vg), do)

            n_calls = 4
            _kernels.reset_launches()
            for _ in range(n_calls):
                fwd_bwd()
            torch.cuda.synchronize()
            per_head = dict(_kernels.LAUNCHES)
            want_counts = _counts(flash_fwd=n_calls, flash_bwd_dkv=n_calls,
                                  flash_bwd_dq=n_calls)
            check(per_head == want_counts,
                  f"the fp32 per-head path launched {per_head}, want {want_counts}")
            oh, lseh = fa.mh_flash_forward(q, k, v, seg, None, **kwh)
            argsh = (q, k, v, do, lseh, (oh * do).sum(-1), seg, None)
            wanth = fa.mh_flash_backward_plain(*argsh, **kwh)
            qn, kn, vn = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib_h, _ = _sdpa(qn, kn, vn, dropout_p=TRAIN_DROPOUT, scale=scale)
            nb = 4 * B * T * H * D * 4 + B * T * H * 4
            errs = {"flash_fwd": _hold_fwd((oh, lseh), fa.mh_flash_forward_plain(
                        q, k, v, seg, None, block_kv=fa.kernel_kv_tile(f32, D), **kwh),
                        "float32", "fp32 per-head"),
                    "flash_bwd_dkv": _hold_bwd(fa.mh_flash_bwd_dkv(*argsh, **kwh), wanth[1:],
                                               "float32", "fp32 per-head dkv")[1],
                    "flash_bwd_dq": _hold_bwd((fa.mh_flash_bwd_dq(*argsh, **kwh),), wanth[:1],
                                              "float32", "fp32 per-head dq")[1]}
            for name, fn, pfn, bound, bound_all, lib, source, line, ffma in (
                    ("flash_fwd", lambda: fa.mh_flash_forward(q, k, v, seg, None, **kwh),
                     lambda: fa.mh_flash_forward_plain(q, k, v, seg, None, **kwh),
                     _bound(3 * 4.0 * pairs * H * D, nb, PEAK_TF32_FLOPS),
                     _bound(3 * 4.0 * B * T * T * H * D, nb, PEAK_TF32_FLOPS), lib_h,
                     "mh_flash_fwd.cu", 110, (_bound(4.0 * pairs * H * D, nb, PEAK_F32_FLOPS),
                                              _bound(4.0 * B * T * T * H * D, nb,
                                                     PEAK_F32_FLOPS))),
                    ("flash_bwd_dkv", lambda: fa.mh_flash_bwd_dkv(*argsh, **kwh),
                     lambda: fa.mh_flash_bwd_dkv_plain(*argsh, **kwh),
                     _bwd_bound(B, T, H, D, pairs, "dkv", **tf32_kw),
                     _bwd_bound(B, T, H, D, None, "dkv", **tf32_kw), None,
                     "mh_flash_bwd_dkv.cu", 240, (_bwd_bound(B, T, H, D, pairs, "dkv", **bound_kw),
                                                  _bwd_bound(B, T, H, D, None, "dkv",
                                                             **bound_kw))),
                    ("flash_bwd_dq", lambda: fa.mh_flash_bwd_dq(*argsh, **kwh),
                     lambda: fa.mh_flash_bwd_dq_plain(*argsh, **kwh),
                     _bwd_bound(B, T, H, D, pairs, "dq", **tf32_kw),
                     _bwd_bound(B, T, H, D, None, "dq", **tf32_kw), None,
                     "mh_flash_bwd_dq.cu", 301, (_bwd_bound(B, T, H, D, pairs, "dq", **bound_kw),
                                                 _bwd_bound(B, T, H, D, None, "dq",
                                                            **bound_kw)))):
                row(name, source, f"omnibiote_tpu/ops/flash_attention.py:{line}",
                    cuda_ms(fn, 10), None, cuda_ms(pfn, 2, warmup=1), bound, bound_all, lib,
                    errs[name], ffma)
            del oh, lseh, argsh, wanth, qn, kn, vn
        del q, k, v, do, o, lse, args, want
        torch.cuda.empty_cache()

    # #9 at the serving shape, dense, no dropout
    B, T = SERVING_BATCH, 1024
    q, k, v, _, rope = _attn_inputs(B, T, H, D, f32, "dense", 2800)
    o8 = i8.int8_flash_attention(q, k, v, scale=scale, rope=rope)
    p8 = i8.int8_flash_attention_plain(q, k, v, scale=scale, rope=rope)
    rt, at = INT8_TOL["float32"]
    check(torch.allclose(o8, p8, rtol=rt, atol=at),
          f"the fp32 int8 kernel disagrees with its plain version at B={B} T={T}")
    qr, kr = apply_rope_half(q, k, *rope)
    lib9, _ = _sdpa(*(x.transpose(1, 2).contiguous() for x in (qr, kr, v)), scale=scale)
    b9 = _int8_bound(B, T, H, D, 4)
    row("int8_flash_fwd", "int8_flash_fwd.cu", "omnibiote_tpu/ops/int8_attention.py:48",
        cuda_ms(lambda: i8.int8_flash_attention(q, k, v, scale=scale, rope=rope), 10), None,
        cuda_ms(lambda: i8.int8_flash_attention_plain(q, k, v, scale=scale, rope=rope), 2,
                warmup=1), b9, b9, None, _abs_err(o8, p8))
    print(f"  (int8_flash_fwd fp32 has no library counterpart; for context SDPA fp32 dense "
          f"{lib9:.4f} ms)")
    del q, k, v, o8, p8, qr, kr
    torch.cuda.empty_cache()
    return rows, per_head


def _f32_micro_batch(model, tokens, segments, label):
    """(loss, {name: grad}, grad_norm) of one fp32 micro-batch of mlm_loss."""
    import torch
    from omnibiote_tpu_torch.training.mlm import mlm_loss
    from omnibiote_tpu_torch.training.train import _compute_copy

    params_c = _compute_copy(dict(model.named_parameters()), model.cfg)
    check(all(p.dtype == torch.float32 for p in params_c.values()),
          f"{label}: the compute copy is not fp32")
    loss, _ = mlm_loss(model, tokens, segments, 4321, params=params_c)
    grads = dict(zip(params_c, torch.autograd.grad(loss, list(params_c.values()))))
    gnorm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    return loss.item(), grads, gnorm


def fp32_phase(workdir, tok_path, seqs, rate16):
    """Phase 23: omnibiote-small at full width and depth in fp32 compute,
    from a checkpoint whose meta.json says float32, through the port's
    console scripts and its Python entries: serving (#1, #9), training on
    the fused backward (#2, #3) and the split pair (#4, #5), and every fp32
    kernel timed. Returns (the fp32 rows of the kernels line with their
    launches, the launches of each path)."""
    import numpy as np
    import torch
    from omnibiote_tpu_torch import encode, init_params, preset
    from omnibiote_tpu_torch.api import Encoder
    from omnibiote_tpu_torch.config import TrainConfig
    from omnibiote_tpu_torch.ops import _kernels
    from omnibiote_tpu_torch.ops import attention as port_attention
    from omnibiote_tpu_torch.ops.int8_attention import int8_flash_attention_plain
    from omnibiote_tpu_torch.training.checkpoint import save_model_checkpoint
    from omnibiote_tpu_torch.training.train import Trainer

    t_phase = time.time()
    _f32_rebuilt_checks()
    cfg = preset("omnibiote-small", vocab_size=65536, dropout=0.0, compute_dtype="float32")
    check((cfg.n_layer, cfg.n_embd, cfg.n_head, cfg.block_size, cfg.param_dtype)
          == (8, 1024, 8, 1024, "float32"), f"unexpected omnibiote-small config {cfg}")
    L = cfg.n_layer
    model = init_params(torch.Generator(device="cuda").manual_seed(23), cfg, device="cuda")
    ckpt = save_model_checkpoint(model, os.path.join(workdir, "f32_ckpt"))
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta_dtype = json.load(f)["model_cfg"]["compute_dtype"]
    check(meta_dtype == "float32", f"the checkpoint's meta.json says {meta_dtype}")
    del model
    fasta = os.path.join(workdir, "f32_seqs.fa")
    with open(fasta, "w") as f:
        f.writelines(f">s{i}\n{s}\n" for i, s in enumerate(seqs))
    emb_path = os.path.join(workdir, "f32_emb.npz")
    data = os.path.join(workdir, "f32_data")
    _write_shards(data, 200_000, seed=23)
    # both console scripts, while this process checks the kernels
    encode_argv = ["--checkpoint", ckpt, "--fasta", fasta, "--out", emb_path,
                   "--tokenizer-path", tok_path]
    train_argv = ["--base_dir", data, "--train_type", "mixed", "--n_layer", str(L),
                  "--n_embd", "1024", "--n_head", "8", "--ctx_len", "1024",
                  "--dropout", str(TRAIN_DROPOUT), "--mini_batch_size", "16",
                  "--batch_size", "32", "--max_steps", "2",
                  "--save_dir", os.path.join(workdir, "f32_cli_ckpt"),
                  "--metrics_jsonl", os.path.join(workdir, "f32_cli.jsonl"),
                  "--log_every", "1", "--test_freq", "50000"]
    print("obt-torch-encode " + " ".join(encode_argv))
    print("obt-torch-train " + " ".join(train_argv) + " (bf16: the CLI has no dtype flag)")
    t_scripts = time.time()
    procs = {"obt-torch-encode": _console_script("omnibiote_tpu_torch.api", encode_argv),
             "obt-torch-train": _console_script("omnibiote_tpu_torch.training.cli", train_argv)}

    # -- serving: Encoder.from_checkpoint, fp32 compute --------------------
    enc = Encoder.from_checkpoint(ckpt, tokenizer_path=tok_path)
    model = enc.model
    check(enc.cfg.compute_dtype == "float32" and next(model.parameters()).is_cuda,
          f"Encoder.from_checkpoint: compute {enc.cfg.compute_dtype} on "
          f"{next(model.parameters()).device}")
    gen = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randint(20, 65000, (SERVING_BATCH, cfg.block_size), generator=gen, device="cuda")
    n_runs = 2
    _kernels.reset_launches()       # the serving path: counts at 0 just before
    with torch.inference_mode():
        for _ in range(n_runs):
            e32 = encode(model, x, "mean")
    torch.cuda.synchronize()
    serving = dict(_kernels.LAUNCHES)
    check(serving == _counts(mh_flash_fwd=L * n_runs),
          f"fp32 encode launched {serving}, want {L * n_runs} of mh_flash_fwd")
    check(e32.dtype == torch.float32 and e32.shape == (SERVING_BATCH, cfg.n_embd)
          and bool(torch.isfinite(e32).all()), "fp32 embeddings: dtype, shape or non-finite")
    with _plain_attention(), torch.inference_mode():
        e_plain = encode(model, x, "mean")
    cos_plain = _min_row_cosine(e32.cpu().numpy(), e_plain.cpu().numpy())
    print(f"fp32 serving: Encoder.from_checkpoint (meta.json compute_dtype float32), encode(mean) "
          f"at B={SERVING_BATCH} T={cfg.block_size} x {n_runs}: launches {serving}; min row "
          f"cosine vs the plain attention {cos_plain:.8f} (threshold {F32_MIN_COSINE})")
    check(cos_plain >= F32_MIN_COSINE, "fp32 encode: kernels vs plain attention")
    # int8 weights and attention on the fp32 model: #9's fp32 instance
    enc8 = Encoder(model, enc.sp, quantize=True, quantize_attention=True)
    check(enc8.cfg.attn_int8 and enc8.cfg.compute_dtype == "float32", "the fp32 int8 Encoder")
    _kernels.reset_launches()
    with torch.inference_mode():
        for _ in range(n_runs):
            e8 = encode(enc8.model, x, "mean")
    torch.cuda.synchronize()
    int8_serving = dict(_kernels.LAUNCHES)
    check(int8_serving == _counts(int8_flash_fwd=L * n_runs),
          f"fp32 int8 encode launched {int8_serving}, want {L * n_runs} of int8_flash_fwd")
    kernel_fn = port_attention.int8_flash_attention
    port_attention.int8_flash_attention = int8_flash_attention_plain
    try:
        with torch.inference_mode():
            e8_plain = encode(enc8.model, x, "mean")
    finally:
        port_attention.int8_flash_attention = kernel_fn
    cos8_plain = _min_row_cosine(e8.cpu().numpy(), e8_plain.cpu().numpy())
    cos8_f32 = _min_row_cosine(e8.cpu().numpy(), e32.cpu().numpy())
    print(f"fp32 int8 serving (quantize=True, quantize_attention=True): launches {int8_serving}; "
          f"min row cosine vs plain int8 attention {cos8_plain:.7f} (threshold {MIN_COSINE}), "
          f"vs the fp32 embeddings {cos8_f32:.6f} (threshold {MIN_COSINE_INT8})")
    check(cos8_plain >= MIN_COSINE, "fp32 int8 encode: kernel vs plain int8 attention")
    check(cos8_f32 >= MIN_COSINE_INT8, "fp32 int8 encode vs the fp32 embeddings")
    del e_plain, e8, e8_plain

    # -- training at dropout 0: kernels (fused, split) vs plain ------------
    mini, accum, ctx = 16, 2, 1024
    batch = next(bench_batches(mini, ctx, seed=25))
    tokens = torch.from_numpy(batch["tokens"]).cuda()
    segments = torch.from_numpy(batch["segments"]).cuda()
    with _plain_attention():
        ref = _f32_micro_batch(model, tokens, segments, "plain")
    for label, flags in (("fused", dict(FUSED_SINGLE_KV_BWD=True)),
                         ("split pair", dict(FUSED_SINGLE_KV_BWD=False))):
        _kernels.reset_launches()
        with _attention_switch(**flags):
            got = _f32_micro_batch(model, tokens, segments, label)
        want = (_counts(mh_flash_fwd=L, mh_flash_bwd=L) if label == "fused" else
                _counts(mh_flash_fwd=L, mh_flash_bwd_dkv=L, mh_flash_bwd_dq=L))
        check(_kernels.LAUNCHES == want, f"fp32 micro-batch ({label}) launched "
              f"{dict(_kernels.LAUNCHES)}, want {want}")
        worst = min(torch.nn.functional.cosine_similarity(
            got[1][n].double().flatten(), ref[1][n].double().flatten(), dim=0).item()
            for n in ref[1])
        d_loss, d_gn = abs(got[0] - ref[0]), abs(got[2] - ref[2]) / ref[2]
        print(f"fp32 train micro-batch ({label}, mini {mini}, T {ctx}, dropout 0): loss "
              f"{got[0]:.7f} vs plain {ref[0]:.7f} (|d| {d_loss:.2e}, limit {F32_LOSS_ATOL}); "
              f"worst gradient cosine {worst:.7f} over {len(ref[1])} tensors (limit "
              f"{F32_GRAD_COS}); grad_norm {got[2]:.6f} vs {ref[2]:.6f} (relative {d_gn:.2e}, "
              f"limit {F32_GNORM_RTOL})")
        check(d_loss <= F32_LOSS_ATOL and worst >= F32_GRAD_COS and d_gn <= F32_GNORM_RTOL,
              f"fp32 training ({label}) against the plain attention")
        del got
    del ref, enc, enc8, model
    torch.cuda.empty_cache()

    # -- the console scripts' results -------------------------------------
    for name, proc in procs.items():
        _wait_script(proc, name)
    print(f"console scripts: both exited 0 in {time.time() - t_scripts:.1f} s")
    with np.load(emb_path) as z:
        ids, emb = list(z["ids"]), z["embeddings"]
    check(ids == [f"s{i}" for i in range(len(seqs))] and emb.shape == (len(seqs), cfg.n_embd),
          "obt-torch-encode's ids or shape")
    enc = Encoder.from_checkpoint(ckpt, tokenizer_path=tok_path)
    same = enc.encode_sequences(seqs, method="mean")
    cos_cli = _min_row_cosine(emb, same)
    print(f"obt-torch-encode: {emb.shape[0]} fp32 embeddings, min row cosine vs "
          f"Encoder.from_checkpoint in this process {cos_cli:.8f} (threshold {F32_MIN_COSINE})")
    check(cos_cli >= F32_MIN_COSINE, "obt-torch-encode vs Encoder.from_checkpoint")
    with open(os.path.join(workdir, "f32_cli.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    check(len(losses) == 2 and all(math.isfinite(v) for v in losses),
          f"obt-torch-train losses {losses}")
    print(f"obt-torch-train: 2 steps, losses {[round(v, 4) for v in losses]}")

    # -- serving rate --------------------------------------------------------
    rate32 = _encode_rate(enc.model, x, "fp32", steps=4)
    print(f"encode(mean) fp32 {rate32:.1f} seq/s against bf16 {rate16:.1f} seq/s in this run "
          f"({rate32 / rate16:.4f} x)")
    del enc, x
    torch.cuda.empty_cache()

    # -- training runs: fused, split pair, one step at ctx 2048 --------------
    training = {}
    for label, ctx_t, mini_t, flags, steps in (
            ("ctx 1024, fused", 1024, 16, dict(FUSED_SINGLE_KV_BWD=True), 2),
            ("ctx 1024, split pair", 1024, 16, dict(FUSED_SINGLE_KV_BWD=False), 2),
            ("ctx 2048, fused", 2048, 8, dict(FUSED_MULTIKV_BWD=True), 1)):
        cfg_r = preset("omnibiote-small", vocab_size=65536, dropout=TRAIN_DROPOUT,
                       compute_dtype="float32", block_size=ctx_t)
        tc = TrainConfig(batch_size=2 * mini_t, mini_batch_size=mini_t, ctx_len=ctx_t,
                         token_budget=float(2 * mini_t * ctx_t * 10000), seed=0)
        n_eos = 3 if ctx_t == 1024 else LONG_EOS
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with _attention_switch(**flags), Trainer(
                cfg_r, tc, batch_iter=bench_batches(tc.batch_size, ctx_t, 26, n_eos),
                prefetch=2) as tr:
            check(tr.model_cfg.compute_dtype == "float32", "the fp32 Trainer")
            tr.train_step_once()
            torch.cuda.synchronize()
            _kernels.reset_launches()     # the path: counts at 0 just before
            t0 = time.time()
            for _ in range(steps):
                m = tr.train_step_once()
            torch.cuda.synchronize()
            dt = time.time() - t0
            launches = dict(_kernels.LAUNCHES)
            loss = float(m["loss"])
        n = L * 2 * steps
        want = (_counts(mh_flash_fwd=n, mh_flash_bwd_dkv=n, mh_flash_bwd_dq=n) if "split" in label
                else _counts(mh_flash_fwd=n, **{"mh_flash_bwd" if ctx_t == 1024
                                                else "mh_flash_bwd_mk": n}))
        check(launches == want, f"fp32 training ({label}) launched {launches}, want {want}")
        check(math.isfinite(loss), f"fp32 training ({label}): loss {loss}")
        tps = steps * tc.batch_size * ctx_t / dt
        print(f"fp32 train {label}: B={tc.batch_size} (mini {mini_t} x accum 2), dropout "
              f"{TRAIN_DROPOUT}, {n_eos} EOS a row: {tps:.1f} tokens/s, {1e3 * dt / steps:.3f} ms "
              f"a step over {steps} step(s) after one, peak allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, loss {loss:.4f}, launches "
              f"{launches}")
        training[label] = launches

    rows, per_head = _f32_timings()
    # each fp32 row's launches: its paths in this phase
    fwd = (serving["mh_flash_fwd"]
           + sum(launches["mh_flash_fwd"] for launches in training.values()))
    for name, n in (("mh_flash_fwd", fwd),
                    ("mh_flash_bwd", training["ctx 1024, fused"]["mh_flash_bwd"]),
                    ("mh_flash_bwd_mk", training["ctx 2048, fused"]["mh_flash_bwd_mk"]),
                    ("mh_flash_bwd_dkv", training["ctx 1024, split pair"]["mh_flash_bwd_dkv"]),
                    ("mh_flash_bwd_dq", training["ctx 1024, split pair"]["mh_flash_bwd_dq"]),
                    ("flash_fwd", per_head["flash_fwd"]),
                    ("flash_bwd_dkv", per_head["flash_bwd_dkv"]),
                    ("flash_bwd_dq", per_head["flash_bwd_dq"]),
                    ("int8_flash_fwd", int8_serving["int8_flash_fwd"])):
        rows[name]["launches"] = n
    print(f"phase 23 (fp32 at omnibiote-small width): {time.time() - t_phase:.1f} s")
    return [rows[name] for name in ("mh_flash_fwd", "mh_flash_bwd", "mh_flash_bwd_mk",
                                    "mh_flash_bwd_dkv", "mh_flash_bwd_dq", "flash_fwd",
                                    "flash_bwd_dkv", "flash_bwd_dq", "int8_flash_fwd")]


def setup():
    """Refuse to run without a card or without the package, and fix the
    fp32 matmul precision the references assume."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")
    if not os.path.isdir(os.path.join(ROOT, "omnibiote_tpu_torch")):
        raise SystemExit("chip_smoke: omnibiote_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main():
    import torch

    setup()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(gpu_name_and_power())
    build()
    serving_err = kernel_phase()
    fwd_row, bwd_row = train_kernel_phase()
    long_rows, fwd_ms_2048, long_err = longctx_kernel_phase()
    int8_row = int8_kernel_phase()
    int8_gemm_phase()
    head_rows, head_launches = per_head_phase()
    print(f"per-head main path launches: {head_launches}")
    _ragged_timings()   # phase 22's timings, before any other profiler session
    probe_rows = probe_phase()
    eval_fwd_err, eval_bwd_err = eval_kernel_phase()
    # each error: the worst over the main paths' shapes (bf16)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], serving_err, long_err,
                                 eval_fwd_err)
    bwd_row["max_abs_err"] = max(bwd_row["max_abs_err"], eval_bwd_err)
    with tempfile.TemporaryDirectory() as workdir:
        serving, served = slice_phase(workdir)
        print(f"serving main path launches: {serving}")
        int8_serving = int8_slice_phase(workdir, served)
        print(f"int8 serving main path launches: {int8_serving}")
        tok_path, seqs, rate16 = served["tok_path"], served["seqs"], served["rate"]
        del served
        torch.cuda.empty_cache()
        train = train_slice_phase(workdir)
        print(f"ctx-1024 training main path launches: {train}")
        long_cli, long_split = longctx_slice_phase(workdir)
        torch.cuda.empty_cache()
        evals = eval_slice_phase(workdir, tok_path)
        print(f"eval slice main path launches: {evals}")
        torch.cuda.empty_cache()
        pretrain, remat_split = pretrain_phase(workdir)
        print(f"pretraining main path launches: {pretrain}; split-pair remat checks: "
              f"{remat_split}")
        torch.cuda.empty_cache()
        contact = contact_phase(workdir, tok_path)
        print(f"contact main path launches: {contact}")
        torch.cuda.empty_cache()
        parallel, parallel_split = parallel_phase(workdir, tok_path)
        print(f"multi-GPU modes main path launches: {parallel}; split pair: {parallel_split}")
        torch.cuda.empty_cache()
        ring, ring_err = sp_phase(workdir)
        torch.cuda.empty_cache()
        pp, pp_split = pp_phase(workdir)
        torch.cuda.empty_cache()
        held_out, held_err = pod_plan_phase()
        torch.cuda.empty_cache()
        wide_rows, wide_err, rates8 = head_dim_256_phase(workdir, tok_path, seqs)
        torch.cuda.empty_cache()
        wider_rows, wider_err, _ = head_dim_wide_phase(workdir, tok_path, seqs, rates8)
        torch.cuda.empty_cache()
        ref_ckpt = reference_checkpoint_phase(workdir, tok_path, seqs, rate16)
        print(f"reference checkpoint main path launches: {ref_ckpt}")
        torch.cuda.empty_cache()
        ragged128, ragged512, ragged_err = ragged_t_phase()
        torch.cuda.empty_cache()
        f32_rows = fp32_phase(workdir, tok_path, seqs, rate16)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"], ring_err["fwd"], held_err["fwd"],
                                 ragged_err["fwd"])
    bwd_row["max_abs_err"] = max(bwd_row["max_abs_err"], ring_err["bwd"], held_err["bwd"],
                                 ragged_err["bwd"])
    # each row's launches: the count its own main paths left (serving, both
    # training contexts, the eval slice, pretraining from raw records, the
    # contact eval, the multi-GPU modes, the pipeline's CLI and the pod
    # planner's held-out model for the forward; the ctx-1024 training, the
    # eval slice, pretraining, the contact eval, the multi-GPU modes, the
    # pipeline's CLI and the held-out model for the fused backward; the
    # split pair's at ctx 2048, in the multi-GPU phase and in the pp
    # Trainer's run; and the ring path's for #1-#5)
    fwd_row["launches"] = (serving["mh_flash_fwd"] + train["mh_flash_fwd"]
                           + long_cli["mh_flash_fwd"] + evals["mh_flash_fwd"]
                           + pretrain["mh_flash_fwd"] + contact["mh_flash_fwd"]
                           + parallel["mh_flash_fwd"] + ring["mh_flash_fwd"]
                           + pp["mh_flash_fwd"] + held_out["mh_flash_fwd"])
    bwd_row["launches"] = (train["mh_flash_bwd"] + evals["mh_flash_bwd"]
                           + pretrain["mh_flash_bwd"] + contact["mh_flash_bwd"]
                           + parallel["mh_flash_bwd"] + ring["mh_flash_bwd"]
                           + pp["mh_flash_bwd"] + held_out["mh_flash_bwd"])
    for row in long_rows:
        source = long_cli if row["name"] == "mh_flash_bwd_mk" else long_split
        row["launches"] = (source[row["name"]] + parallel_split.get(row["name"], 0)
                           + ring[row["name"]] + pp_split.get(row["name"], 0))
    int8_row["launches"] = int8_serving["int8_flash_fwd"]
    rows = [fwd_row, bwd_row, *long_rows, int8_row, *head_rows, *probe_rows, *wide_rows,
            *wider_rows]
    # the converted reference checkpoint's path (#1, #9), and the ragged-T
    # calls, each added to the row of its kernel at its head dim
    fwd_row["launches"] += ref_ckpt["mh_flash_fwd"]
    int8_row["launches"] += ref_ckpt["int8_flash_fwd"]
    for row in rows:
        name, _, dim = row["name"].partition(" D=")
        row["launches"] += {"": ragged128, "512": ragged512}.get(dim, {}).get(name, 0)
    # the fp32 instances of #1-#9, each launched on phase 23's paths
    rows += f32_rows
    check(min(serving["mh_flash_fwd"], train["mh_flash_fwd"], long_cli["mh_flash_fwd"],
              evals["mh_flash_fwd"], pretrain["mh_flash_fwd"], contact["mh_flash_fwd"],
              parallel["mh_flash_fwd"], pp["mh_flash_fwd"]) > 0,
          "a main path never launched mh_flash_fwd")
    check(min(train["mh_flash_bwd"], evals["mh_flash_bwd"], pretrain["mh_flash_bwd"],
              contact["mh_flash_bwd"], parallel["mh_flash_bwd"], pp["mh_flash_bwd"]) > 0,
          "a main path never launched mh_flash_bwd")
    check(min(pp_split.get("mh_flash_bwd_dkv", 0), pp_split.get("mh_flash_bwd_dq", 0)) > 0,
          "the pp Trainer's split-pair run never launched #4 or #5")
    check(min(parallel_split["mh_flash_bwd_dkv"], parallel_split["mh_flash_bwd_dq"]) > 0,
          "the multi-GPU phase's split-pair run never launched #4 or #5")
    check(min(ring[k] for k in ("mh_flash_fwd", "mh_flash_bwd", "mh_flash_bwd_mk",
                                "mh_flash_bwd_dkv", "mh_flash_bwd_dq")) > 0,
          f"the ring path never launched one of #1-#5: {ring}")
    check(len(rows) == 40 and all(row["launches"] > 0 for row in rows),
          f"a kernel was never launched on its main path: "
          f"{[(row['name'], row['launches']) for row in rows]}")
    print(f"mh_flash_fwd at the long shape (mini 8, T 2048, skipping): {fwd_ms_2048:.4f} ms")
    print(f"head dim 256 kernel checks: worst bf16 max|do| {wide_err['fwd']:.3e}, max|d| "
          f"{wide_err['bwd']:.3e}")
    print(f"head dims past 256 kernel checks: worst bf16 max|do| {wider_err['fwd']:.3e}, "
          f"max|d| {wider_err['bwd']:.3e}")
    print(f"ragged-T calls: worst bf16 max|do| {ragged_err['fwd']:.3e}, max|d| "
          f"{ragged_err['bwd']:.3e}")
    print(gpu_name_and_power())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
