"""Roofline of the flash attention kernel's two products on the H100.

Port of `tools/probes/roofline.py`: how fast do the multi-head forward's
products run with the same grid and data movement but without softmax,
mask or dropout? Two probes, each a CUDA kernel (`ops/csrc/
roofline_probes.cu`) with its plain PyTorch version beside it, and #1's own
kernel with its products alone (`fwd_products`):

  * `dots_only` (`_dots_kernel`, roofline.py:54): per head,
    o = round(Σ over kv tiles fp32(round(q_h k_hᵀ) · v_h)), where round is
    to the inputs' dtype: #1's two products, nothing else. The result does
    not depend on (block_q, block_kv) but through the fp32 sum's order.
  * `dots_n` (`_dots_n_kernel`, roofline.py:163): per head and tile pair
    (q tile qt of block_q rows, kv tile kt of block_kv rows),
    S = round(Q_qt K_ktᵀ + Q_qt V_ktᵀ) and
    o[qt·block_q + r] += Σ_i S[i, r] · (Q_qt[i] (+ V_kt[i] with n_dots=4)),
    where r < block_q indexes rows *local to the kv tile*: the backward's
    dkv product mix (3 or 4 products a tile). It depends on the tiles, so
    they stay function arguments, and the combinations the JAX probe cannot
    take raise ValueError: block_q > block_kv, and block_q != block_kv with
    4 products.

A CUDA tensor runs the kernel, a CPU tensor the plain version. `cta_q` is
the kernel's CTA height in query rows (64 or 128, #1's); it does not change
the function. `dots_only` runs `dots_wgmma`: #1's product pipeline (a TMA
ring of 128-row K and V tiles, wgmma consumers of 64 q rows, S rounded in
registers as the A operand of S·V) in persistent CTAs, one a
multiprocessor walking the (b, h, q tile) work items (`persistent=False`
launches one CTA an item instead, which measured slower: PERF.md §6);
`dots_n` runs `dots_n_wgmma`, the dkv kernel's consumer scheme on the
kv-local rows (a TMA ring of q chunks and the kv tile's K/V rows; per chunk
both score products into one fp32 accumulator by wgmma, rounded in
registers as the A operand of S^T·Q (and S^T·V); o out by TMA stores),
persistent too. `bwd_products` is #2/#3's
fused backward kernel with its five products alone, the backward's
counterpart of `fwd_products`; `dkv_products` and `dq_products` the split
pair's kernels (#4/#7 and #5/#8) with theirs, `dkv_products` the
counterpart of `dots_n`'s dkv mix; and `int8_products` #9's int8 attention
kernel with its two walks' s8 products alone.

    python -m omnibiote_tpu_torch.probes.roofline

prints the JAX probe's table at its shape (B=8, T=1024, H=8, D=128, bf16),
timed by CUDA events over repeated launches on one input.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.flash_attention import _raise_on
from ..utils.device import resolve_device

# What the kernels are built for: head dim, the T multiple of every probe,
# the dots kernel's kv tile (T need not be a multiple of it: the last tile
# reads zeros past T), the CTA heights in q rows (the dots_n kernel's BR),
# and the dots_n kernel's q chunk: DOTS_N_CHUNK rows where block_q is a
# multiple of it, else DOTS_N_CHUNK_NARROW. KERNEL_KV_TILE and the chunks
# are copies of kKv, kNChunk and kNChunkNarrow in
# ops/csrc/roofline_probes.cu for the CPU mirrors of the walks
# (tests/test_torch_probe_tiles.py); no launch reads them. chip_smoke.py
# phase 11 holds them against the built library (`obt_roofline_tile`).
KERNEL_HEAD_DIM = 128
KERNEL_T_MULTIPLE = 64
KERNEL_KV_TILE = 128
CTA_ROWS = (64, 128)
DOTS_N_CHUNK = 128
DOTS_N_CHUNK_NARROW = 64

# NVIDIA H100 SXM data sheet, dense bf16 tensor cores.
PEAK_BF16_FLOPS = 989e12

# The probes' shape (roofline.py:21).
PROBE_SHAPE = dict(B=8, T=1024, H=8, D=128)


def check_blocks(T: int, block_q: int, block_kv: int) -> None:
    if block_q < 1 or block_kv < 1 or T % block_q or T % block_kv:
        raise ValueError(f"block_q={block_q} and block_kv={block_kv} must "
                         f"divide T={T}")


def _check_cta(cta_q: int) -> None:
    if cta_q not in CTA_ROWS:
        raise ValueError(f"cta_q={cta_q} not built; one of {CTA_ROWS}")


def _check_dots_n(T: int, block_q: int, block_kv: int, n_dots: int) -> None:
    check_blocks(T, block_q, block_kv)
    if n_dots not in (3, 4):
        raise ValueError(f"n_dots={n_dots}; the probe has 3 or 4 products")
    if block_q > block_kv:
        raise ValueError(f"block_q={block_q} > block_kv={block_kv}: the "
                         "kv-local rows r < block_q would leave the kv tile")
    if n_dots == 4 and block_q != block_kv:
        raise ValueError(f"4 products need block_q == block_kv, got "
                         f"{block_q} and {block_kv}")


# ---------------------------------------------------------------------------
# Plain versions: fp32 products of values in the inputs' dtype, rounded to
# that dtype where the TPU kernels round, walking the same tiles.
# ---------------------------------------------------------------------------

def dots_plain_heads(q, k_t, v, block_kv: int) -> torch.Tensor:
    """`dots_only` with k given per head and transposed, k_t (B, H, D, T);
    q, v (B, T, H, D). Rows of q are independent, so q is not tiled."""
    B, T, H, D = q.shape
    qh = q.permute(0, 2, 1, 3).float()
    vh = v.permute(0, 2, 1, 3).float()
    kf = k_t.float()
    acc = torch.zeros((B, H, T, D), dtype=torch.float32, device=q.device)
    for j in range(0, T, block_kv):
        s = torch.matmul(qh, kf[..., j:j + block_kv])
        acc += torch.matmul(s.to(q.dtype).float(), vh[:, :, j:j + block_kv])
    return acc.to(q.dtype).permute(0, 2, 1, 3).contiguous()


def dots_only_plain(q, k, v, block_q: int, block_kv: int) -> torch.Tensor:
    """Plain version of `dots_only`: q, k, v (B, T, H, D) -> o (B, T, H, D)."""
    check_blocks(q.shape[1], block_q, block_kv)
    return dots_plain_heads(q, k.permute(0, 2, 3, 1), v, block_kv)


def dots_n_plain(q, k, v, block_q: int, block_kv: int,
                 n_dots: int) -> torch.Tensor:
    """Plain version of `dots_n`: q, k, v (B, T, H, D) -> o (B, T, H, D)."""
    B, T, H, D = q.shape
    _check_dots_n(T, block_q, block_kv, n_dots)
    nq = T // block_q
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    qt = qh.reshape(B, H, nq, block_q, D)
    acc = torch.zeros((B, H, nq, block_q, D), dtype=torch.float32,
                      device=q.device)
    for j in range(0, T, block_kv):
        # only the kv tile's first block_q rows (columns r of S) reach o
        kr = kh[:, :, None, j:j + block_q].transpose(-1, -2)
        vr = vh[:, :, None, j:j + block_q].transpose(-1, -2)
        s = torch.matmul(qt, kr) + torch.matmul(qt, vr)         # (.., i, r)
        st = s.to(q.dtype).float().transpose(-1, -2)             # (.., r, i)
        a = torch.matmul(st, qt)
        if n_dots == 4:
            a = a + torch.matmul(st, vh[:, :, None, j:j + block_kv])
        acc += a
    return (acc.reshape(B, H, T, D).to(q.dtype).permute(0, 2, 1, 3)
            .contiguous())


def bwd_products_plain(q, k, v, do):
    """Plain version of `bwd_products`: per head, P = round(k·qᵀ) and
    dS = round(v·doᵀ) (kv rows by q rows, fp32 products rounded to the
    inputs' dtype), then (dq, dk, dv) = round(dSᵀ·k), round(dS·q),
    round(P·do) from fp32 products, each (B, T, H, D)."""
    qh, kh, vh, oh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, do))
    p = torch.matmul(kh, qh.transpose(-1, -2)).to(q.dtype).float()
    ds = torch.matmul(vh, oh.transpose(-1, -2)).to(q.dtype).float()
    grads = (torch.matmul(ds.transpose(-1, -2), kh), torch.matmul(ds, qh),
             torch.matmul(p, oh))
    return tuple(g.to(q.dtype).permute(0, 2, 1, 3).contiguous() for g in grads)


def dkv_products_plain(q, k, v, do):
    """Plain version of `dkv_products`: (dk, dv) of `bwd_products_plain`."""
    return bwd_products_plain(q, k, v, do)[1:]


def dq_products_plain(q, k, v, do):
    """Plain version of `dq_products`: per head, dS = round(q·kᵀ + do·vᵀ)
    (fp32 products and sum, rounded to the inputs' dtype), then
    dq = round(dS·k) from an fp32 product, (B, T, H, D)."""
    qh, kh, vh, oh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v, do))
    ds = (torch.matmul(qh, kh.transpose(-1, -2))
          + torch.matmul(oh, vh.transpose(-1, -2))).to(q.dtype).float()
    return (torch.matmul(ds, kh).to(q.dtype).permute(0, 2, 1, 3)
            .contiguous())


def int8_products_plain(q8, k8, v8t):
    """Plain version of `int8_products`: per head, S = q8·k8ᵀ in int32,
    m its row max and p8 = the low byte of S as a two's-complement int8;
    o (B, T, H, D) int32 = m + p8·v8, with v8 the natural kv order of v8t
    (given in the kernel's layout, `int8_natural_layout`)."""
    from ..ops.int8_attention import _int_matmul, int8_natural_layout

    v8 = int8_natural_layout(None, None, None, None, v8t, None)[4].transpose(-1, -2)
    s = _int_matmul(q8, k8.transpose(-1, -2))
    p8 = ((s + 128) & 0xff) - 128
    o = _int_matmul(p8, v8) + s.amax(dim=-1, keepdim=True)
    return o.permute(0, 2, 1, 3).contiguous()


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def check_kernel_inputs(q, named) -> None:
    """q (B, T, H, 128) and each (name, tensor, shape) of `named`: bf16,
    contiguous, 16-byte aligned CUDA tensors on q's device."""
    B, T, H, D = q.shape
    for name, t, shape in (("q", q, q.shape), *named):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{name} is not a CUDA tensor on q's device "
                             f"({t.device})")
        if t.dtype != torch.bfloat16 or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"{tuple(shape)} bfloat16")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if D != KERNEL_HEAD_DIM:
        raise ValueError(f"head_dim {D} not built; the probes take "
                         f"{KERNEL_HEAD_DIM}")
    if T % KERNEL_T_MULTIPLE:
        raise ValueError(f"T={T} must be a multiple of {KERNEL_T_MULTIPLE}")


def launch(entry: str, counter: str, q, operands, *ints) -> torch.Tensor:
    """Run C entry `entry` of the probes' library on (q, *operands) into a
    new o of q's shape; adds one to LAUNCHES[counter]."""
    from ..ops import _kernels

    B, T, H, D = q.shape
    o = torch.empty_like(q)
    lib = _kernels.load_library("roofline_probes")
    args = (q.data_ptr(), *(t.data_ptr() for t in operands), o.data_ptr(),
            B, T, H, D, *ints, torch.cuda.current_stream(q.device).cuda_stream)
    # the device is switched only where it must be: a call's host time is
    # close to the wgmma probes' device time (PERF.md §4), and a switch adds
    # to it
    if q.device.index == torch.cuda.current_device():
        err = getattr(lib, entry)(*args)
    else:
        with torch.cuda.device(q.device):
            err = getattr(lib, entry)(*args)
    _raise_on(err, entry, lib.obt_cuda_error_string_roofline)
    _kernels.LAUNCHES[counter] += 1
    return o


def dots_kernel(q, k, v, *, kt: bool, cta_q: int, counter: str,
                persistent: bool = True):
    """Launch the dots kernel on CUDA tensors (blocks and cta_q checked by
    the caller): k (B, T, H, D), or (B, H*D, T) with kt; one persistent CTA
    a multiprocessor, or one CTA a work item. Adds one to
    LAUNCHES[counter]."""
    B, T, H, D = q.shape
    k_shape = (B, H * D, T) if kt else q.shape
    check_kernel_inputs(q, (("k", k, k_shape), ("v", v, q.shape)))
    if T % cta_q:
        raise ValueError(f"T={T} must be a multiple of cta_q={cta_q}")
    return launch("obt_roofline_dots", counter, q, (k, v), int(kt), cta_q,
                  int(persistent))


def dots_n_chunk(block_q: int) -> int:
    """The q rows of a chunk the dots_n kernel walks for block_q."""
    return DOTS_N_CHUNK if block_q % DOTS_N_CHUNK == 0 else DOTS_N_CHUNK_NARROW


def _dots_n_kernel(q, k, v, block_q: int, block_kv: int, n_dots: int, *,
                   cta_q: int, persistent: bool = True):
    """Launch the dkv-shaped kernel on CUDA tensors (blocks and cta_q
    checked by `dots_n`): one persistent CTA a multiprocessor, or one CTA a
    work item; counts LAUNCHES['roofline_dots_n']."""
    check_kernel_inputs(q, (("k", k, q.shape), ("v", v, q.shape)))
    if block_q % cta_q:
        raise ValueError(f"block_q={block_q} must be a multiple of "
                         f"cta_q={cta_q}")
    return launch("obt_roofline_dots_n", "roofline_dots_n", q, (k, v),
                  block_q, block_kv, n_dots, cta_q, int(persistent))


def dots_only(q, k, v, block_q: int, block_kv: int, *, cta_q: int = 64):
    """The two products of #1 without softmax: o (B, T, H, D) from q, k, v
    (B, T, H, D). The JAX probe passes one array as q, k and v."""
    check_blocks(q.shape[1], block_q, block_kv)
    _check_cta(cta_q)
    if q.is_cuda:
        return dots_kernel(q, k, v, kt=False, cta_q=cta_q,
                           counter="roofline_dots")
    return dots_only_plain(q, k, v, block_q, block_kv)


def dots_n(q, k, v, block_q: int, block_kv: int, n_dots: int, *,
           cta_q: int = 64):
    """The dkv product mix: o (B, T, H, D) from q, k, v (B, T, H, D)."""
    _check_dots_n(q.shape[1], block_q, block_kv, n_dots)
    _check_cta(cta_q)
    if q.is_cuda:
        return _dots_n_kernel(q, k, v, block_q, block_kv, n_dots, cta_q=cta_q)
    return dots_n_plain(q, k, v, block_q, block_kv, n_dots)


def _kernel_products(library: str, entry: str, err_entry: str, counter: str,
                     q, operands, n_out: int, f32_scratch: bool = False):
    """Run the products-alone entry `entry` of kernel library `library` on
    q and the (name, tensor) `operands`, bf16 CUDA tensors of q's shape,
    into n_out new outputs of q's shape (after an fp32 scratch of q's size
    with f32_scratch); adds one to LAUNCHES[counter]."""
    from ..ops import _kernels

    check_kernel_inputs(q, [(n, t, q.shape) for n, t in operands])
    B, T, H, D = q.shape
    scratch = ([torch.empty(q.shape, dtype=torch.float32, device=q.device)]
               if f32_scratch else [])
    outs = tuple(torch.empty_like(q) for _ in range(n_out))
    lib = _kernels.load_library(library)
    with torch.cuda.device(q.device):
        err = getattr(lib, entry)(
            q.data_ptr(), *(t.data_ptr() for _, t in operands),
            *(t.data_ptr() for t in (*scratch, *outs)), B, T, H, D,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, entry, getattr(lib, err_entry))
    _kernels.LAUNCHES[counter] += 1
    return outs


def fwd_products(q, k, v):
    """#1's own kernel with its products alone (the DOTS instance of
    ops/csrc/mh_flash_fwd.cu: TMA ring, wgmma, no scale, mask or softmax):
    `dots_only`'s function on 128-row kv tiles, o (B, T, H, D) from q, k, v
    (B, T, H, D). A CUDA tensor runs the kernel (counted as
    'mh_flash_fwd_dots'), a CPU tensor `dots_only_plain` on those tiles."""
    from ..ops.flash_attention import KERNEL_KV_TILE

    tile = KERNEL_KV_TILE[torch.bfloat16]
    check_blocks(q.shape[1], tile, tile)
    if not q.is_cuda:
        return dots_only_plain(q, k, v, tile, tile)
    return _kernel_products("mh_flash_fwd", "obt_mh_flash_fwd_dots",
                            "obt_cuda_error_string", "mh_flash_fwd_dots", q,
                            (("k", k), ("v", v)), 1)[0]


def _backward_products(kind: str, plain, q, k, v, do):
    """The backward kernel of `kind` ('fused', 'dkv', 'dq') with its
    products alone: CPU tensors run `plain`, CUDA tensors the kernel's DOTS
    instance (counted as '<library>_dots'), on its own tiles."""
    from ..ops.flash_attention import KERNEL_TILES, _BWD_KERNELS

    check_blocks(q.shape[1], *KERNEL_TILES[kind][torch.bfloat16])
    if not q.is_cuda:
        return plain(q, k, v, do)
    library, err_entry, _, _, f32_scratch, n_out = _BWD_KERNELS[kind]
    outs = _kernel_products(library, f"obt_{library}_dots", err_entry,
                            f"{library}_dots", q, (("k", k), ("v", v), ("do", do)),
                            n_out, f32_scratch)
    return outs if n_out > 1 else outs[0]


def bwd_products(q, k, v, do):
    """The fused backward kernel with its products alone (the DOTS instance
    of ops/csrc/mh_flash_bwd.cu: TMA ring, the five wgmma products, the dq
    reduction; no RoPE, scale, mask, softmax or dropout): (dq, dk, dv)
    (B, T, H, D) from q, k, v, do (B, T, H, D) as `bwd_products_plain`,
    T a multiple of 128. A CUDA tensor runs the kernel (counted as
    'mh_flash_bwd_dots'), a CPU tensor the plain version."""
    return _backward_products("fused", bwd_products_plain, q, k, v, do)


def dkv_products(q, k, v, do):
    """The split pair's dkv kernel with its products alone (the DOTS
    instance of ops/csrc/mh_flash_bwd_dkv.cu: the fused kernel without its
    dq, so its TMA ring and four wgmma products): (dk, dv) (B, T, H, D) as
    `dkv_products_plain`, T a multiple of 128. A CUDA tensor runs the
    kernel (counted as 'mh_flash_bwd_dkv_dots'), a CPU tensor the plain
    version."""
    return _backward_products("dkv", dkv_products_plain, q, k, v, do)


def dq_products(q, k, v, do):
    """The split pair's dq kernel with its products alone (the DOTS instance
    of ops/csrc/mh_flash_bwd_dq.cu: TMA ring, the three wgmma products, the
    TMA-store epilogue; no RoPE, scale, mask, softmax or dropout): dq
    (B, T, H, D) as `dq_products_plain`, T a multiple of 128. A CUDA tensor
    runs the kernel (counted as 'mh_flash_bwd_dq_dots'), a CPU tensor the
    plain version."""
    return _backward_products("dq", dq_products_plain, q, k, v, do)


def int8_products(q8, k8, v8t):
    """#9's attention kernel with its products alone (the DOTS instance of
    ops/csrc/int8_flash_fwd.cu: TMA ring, both walks' s8 wgmma products,
    the turns and the P8 fragment packing; no scales, mask, exp2 or
    division). The cheapest map from S to P8 that keeps both products: walk
    1 keeps the int32 row max m of S, walk 2 takes p8 = the low byte of S.
    q8, k8 (B, H, T, 128) and v8t (B, H, 128, T) int8, v8t in the kernel's
    layout (as int8_quantize_kernel returns it), T a multiple of 128 ->
    o (B, T, H, 128) int32 = m + p8·v8. A CUDA tensor runs the kernel
    (counted as 'int8_flash_fwd_dots'), a CPU tensor the plain version."""
    from ..ops import _kernels
    from ..ops.int8_attention import KERNEL_HEAD_DIM, KERNEL_T_MULTIPLE

    B, H, T, D = q8.shape
    if D != KERNEL_HEAD_DIM or T < KERNEL_T_MULTIPLE or T % KERNEL_T_MULTIPLE:
        raise ValueError(f"q8 {tuple(q8.shape)}: want (B, H, T, "
                         f"{KERNEL_HEAD_DIM}) with T a positive multiple of "
                         f"{KERNEL_T_MULTIPLE}")
    for name, t, shape in (("q8", q8, (B, H, T, D)), ("k8", k8, (B, H, T, D)),
                           ("v8t", v8t, (B, H, D, T))):
        if t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: want "
                             f"{shape} int8")
    if not q8.is_cuda:
        return int8_products_plain(q8, k8, v8t)
    for name, t in (("q8", q8), ("k8", k8), ("v8t", v8t)):
        if (not t.is_cuda or t.device != q8.device or not t.is_contiguous()
                or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             "CUDA tensor on q8's device")
    o = torch.empty((B, T, H, D), dtype=torch.int32, device=q8.device)
    lib = _kernels.load_library("int8_flash_fwd")
    with torch.cuda.device(q8.device):
        err = lib.obt_int8_flash_fwd_dots(
            q8.data_ptr(), k8.data_ptr(), v8t.data_ptr(), o.data_ptr(), B, T, H,
            D, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "int8_flash_fwd_dots", lib.obt_cuda_error_string_int8)
    _kernels.LAUNCHES["int8_flash_fwd_dots"] += 1
    return o


# ---------------------------------------------------------------------------
# The table
# ---------------------------------------------------------------------------

def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms: CUDA events around `iters` calls on
    the same inputs."""
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


def report(table: dict, name: str, fn, flops: float) -> None:
    """Time fn, print its line and keep its ms in table[name]."""
    ms = cuda_ms(fn)
    tf = flops / (ms * 1e-3) / 1e12
    table[name] = ms
    print(f"{name:52s} {ms:8.4f} ms  -> {tf:6.1f} TFLOP/s "
          f"({tf / (PEAK_BF16_FLOPS / 1e12) * 100:5.1f} % of 989)", flush=True)


def normal_bf16(rng, shape, device) -> torch.Tensor:
    """Unit normals of the numpy generator `rng`, in bf16 on `device`."""
    x = rng.standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=torch.bfloat16)


def main() -> dict:
    """Print roofline.py's table on the card; returns {line: ms}."""
    from ..config import EOS_TOKEN
    from ..ops.flash_attention import SegmentBounds, flash_attention
    from ..ops.segments import segment_ids_np

    dev = resolve_device(None)
    B, T, H, D = (PROBE_SHAPE[n] for n in "BTHD")
    rng = np.random.default_rng(0)
    q = normal_bf16(rng, (B, T, H, D), dev)
    toks = rng.integers(20, 65000, size=(B, T)).astype(np.int32)
    for r in range(B):
        toks[r, rng.integers(32, T, size=3)] = EOS_TOKEN
    segs = torch.from_numpy(segment_ids_np(toks)).to(dev)
    scale = 8.0 / 1024
    fwd_flops = 4.0 * B * H * T * T * D       # 2 products: QK^T and PV
    bwd_flops = 2.5 * fwd_flops
    table = {}

    print(f"== roofline @ B={B} T={T} H={H} D={D} bf16 on "
          f"{torch.cuda.get_device_name(dev)} ==")
    M = 4096
    a = normal_bf16(rng, (M, 1024), dev)
    bmat = normal_bf16(rng, (1024, M), dev)
    report(table, "dense (4096x1024)x(1024x4096) torch.matmul",
           lambda: torch.matmul(a, bmat), 2.0 * M * 1024 * M)

    for bq, bkv in [(512, 1024), (512, 512), (1024, 1024), (256, 512)]:
        for cta in CTA_ROWS:
            report(table, f"dots-only fwd bq={bq} bkv={bkv} cta={cta}",
                   lambda bq=bq, bkv=bkv, cta=cta: dots_only(
                       q, q, q, bq, bkv, cta_q=cta), fwd_flops)
    report(table, "products  fwd #1's kernel (wgmma, 128-row tiles)",
           lambda: fwd_products(q, q, q), fwd_flops)
    with torch.no_grad():
        report(table, "full      fwd dense (no segment ids)",
               lambda: flash_attention(q, q, q, None, scale=scale), fwd_flops)
        for bq, bkv in [(512, 1024), (512, 512)]:
            report(table, f"full      fwd bq={bq} bkv={bkv}",
                   lambda bq=bq, bkv=bkv: flash_attention(
                       q, q, q, segs, scale=scale, block_q=bq,
                       block_kv=bkv), fwd_flops)
        # as the model calls it: skip bounds computed once for all layers
        bounds = SegmentBounds(segs)
        report(table, "full      fwd bq=512 bkv=1024 bounds shared",
               lambda: flash_attention(q, q, q, segs, scale=scale, block_q=512,
                                       block_kv=1024, bounds=bounds), fwd_flops)
    c = q.clone().requires_grad_()
    ones = torch.ones_like(q)
    for bq, bkv in [(512, 1024), (512, 512)]:
        report(table, f"full      f+b bq={bq} bkv={bkv}",
               lambda bq=bq, bkv=bkv: torch.autograd.grad(flash_attention(
                   c, c, c, segs, scale=scale, block_q=bq, block_kv=bkv),
                   c, ones), fwd_flops + bwd_flops)
    for nd in (3, 4):
        for cta in CTA_ROWS:
            report(table, f"dots-only {nd}-dot bq=512 bkv=512 cta={cta}",
                   lambda nd=nd, cta=cta: dots_n(q, q, q, 512, 512, nd,
                                                 cta_q=cta),
                   fwd_flops * nd / 2)
    report(table, "products  bwd #2's kernel (wgmma, 64x128 tiles)",
           lambda: bwd_products(q, q, q, q), bwd_flops)
    report(table, "products  dkv #4's kernel (wgmma, 64x128 tiles)",
           lambda: dkv_products(q, q, q, q), 2 * fwd_flops)
    report(table, "products  dq  #5's kernel (wgmma, 128x64 tiles)",
           lambda: dq_products(q, q, q, q), 1.5 * fwd_flops)
    return table


if __name__ == "__main__":
    main()
