"""Build and bind the port's CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and compiles with `nvcc` for
`sm_90a` into `build/lib<name>.so` beside this file at first use (or all at
once, in parallel, through `build_all`), and is loaded with ctypes. Nothing
is built or loaded at import: a CPU-only host imports this module freely.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# Launches per kernel wrapper: each wrapper adds one where it launches.
# The fused backward source serves two counts: "mh_flash_bwd" where one kv
# block spans the sequence (T <= 1024 under the dispatch) and
# "mh_flash_bwd_mk" for the multi-kv case above it. The forward and the
# split pair's sources also serve flash_attention(multi_head=False), without
# RoPE or skip bounds, counted as "flash_fwd", "flash_bwd_dkv" and
# "flash_bwd_dq"; the forward's, the fused backward's and the split pair's
# sources also hold their products alone, counted as "mh_flash_fwd_dots",
# "mh_flash_bwd_dots", "mh_flash_bwd_dkv_dots" and "mh_flash_bwd_dq_dots"
# (probes/roofline.py::fwd_products, bwd_products, dkv_products,
# dq_products), and the int8 source its attention kernel's products alone
# as "int8_flash_fwd_dots" (probes/roofline.py::int8_products). The
# roofline probes' source serves four: "roofline_dots" and "roofline2_dots"
# (one kernel, the probes of roofline.py and roofline2.py),
# "roofline_dots_n" and "roofline2_scores".
LAUNCHES: Dict[str, int] = {"mh_flash_fwd": 0, "mh_flash_fwd_dots": 0,
                            "mh_flash_bwd": 0, "mh_flash_bwd_dots": 0,
                            "mh_flash_bwd_mk": 0, "mh_flash_bwd_dkv": 0,
                            "mh_flash_bwd_dkv_dots": 0, "mh_flash_bwd_dq": 0,
                            "mh_flash_bwd_dq_dots": 0, "int8_flash_fwd": 0,
                            "int8_flash_fwd_dots": 0, "flash_fwd": 0,
                            "flash_bwd_dkv": 0, "flash_bwd_dq": 0,
                            "roofline_dots": 0,
                            "roofline_dots_n": 0, "roofline2_dots": 0,
                            "roofline2_scores": 0}

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_c = ctypes
_SIGNATURES = {
    "mh_flash_fwd": {
        "obt_mh_flash_fwd": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p,                  # q_seg, kv_seg
            _c.c_void_p, _c.c_void_p,                  # cos, sin
            _c.c_void_p, _c.c_void_p,                  # q_rot, k_rot
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # kv_lo, kv_hi, tile_count
            _c.c_void_p, _c.c_void_p,                  # o, lse2
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_float, _c.c_int,                      # scale_log2, dtype
            _c.c_int, _c.c_uint32, _c.c_float,         # drop, thresh, keep_scale
            _c.c_uint64, _c.c_void_p]),                # seed, stream
        "obt_mh_flash_fwd_dots": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p,                               # o
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_void_p]),                             # stream
        "obt_mh_flash_fwd_smem_bytes": (_c.c_int, [_c.c_int]),
        "obt_cuda_error_string": (_c.c_char_p, [_c.c_int]),
    },
    "mh_flash_bwd": {
        "obt_mh_flash_bwd": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # do, lse2, di
            _c.c_void_p, _c.c_void_p,                  # q_seg, kv_seg
            _c.c_void_p, _c.c_void_p,                  # cos, sin
            _c.c_void_p, _c.c_void_p,                  # q_rot, k_rot
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q_lo, q_hi, tile_count
            _c.c_void_p,                               # dq_acc
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # dq, dk, dv
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_float, _c.c_float, _c.c_int,          # scale_log2, scale, dtype
            _c.c_int, _c.c_uint32, _c.c_float,         # drop, thresh, keep_scale
            _c.c_uint64, _c.c_void_p]),                # seed, stream
        "obt_mh_flash_bwd_dots": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p,                  # do, dq_acc
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # dq, dk, dv
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_void_p]),                             # stream
        "obt_mh_flash_bwd_smem_bytes": (_c.c_int, [_c.c_int]),
        "obt_cuda_error_string_bwd": (_c.c_char_p, [_c.c_int]),
    },
    "mh_flash_bwd_dkv": {
        "obt_mh_flash_bwd_dkv": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # do, lse2, di
            _c.c_void_p, _c.c_void_p,                  # q_seg, kv_seg
            _c.c_void_p, _c.c_void_p,                  # cos, sin
            _c.c_void_p, _c.c_void_p,                  # q_rot, k_rot
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q_lo, q_hi, tile_count
            _c.c_void_p, _c.c_void_p,                  # dk, dv
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_float, _c.c_float, _c.c_int,          # scale_log2, scale, dtype
            _c.c_int, _c.c_uint32, _c.c_float,         # drop, thresh, keep_scale
            _c.c_uint64, _c.c_void_p]),                # seed, stream
        "obt_mh_flash_bwd_dkv_dots": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # do, dk, dv
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_void_p]),                             # stream
        "obt_mh_flash_bwd_dkv_smem_bytes": (_c.c_int, [_c.c_int]),
        "obt_cuda_error_string_bwd_dkv": (_c.c_char_p, [_c.c_int]),
    },
    "mh_flash_bwd_dq": {
        "obt_mh_flash_bwd_dq": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # do, lse2, di
            _c.c_void_p, _c.c_void_p,                  # q_seg, kv_seg
            _c.c_void_p, _c.c_void_p,                  # cos, sin
            _c.c_void_p, _c.c_void_p,                  # q_rot, k_rot
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # kv_lo, kv_hi, tile_count
            _c.c_void_p,                               # dq
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_float, _c.c_float, _c.c_int,          # scale_log2, scale, dtype
            _c.c_int, _c.c_uint32, _c.c_float,         # drop, thresh, keep_scale
            _c.c_uint64, _c.c_void_p]),                # seed, stream
        "obt_mh_flash_bwd_dq_dots": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p,                  # do, dq
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_void_p]),                             # stream
        "obt_mh_flash_bwd_dq_smem_bytes": (_c.c_int, [_c.c_int]),
        "obt_cuda_error_string_bwd_dq": (_c.c_char_p, [_c.c_int]),
    },
    "int8_flash_fwd": {
        "obt_int8_flash_fwd": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # seg, cos, sin
            _c.c_void_p, _c.c_void_p,                  # q8, sq
            _c.c_void_p, _c.c_void_p,                  # k8, sk
            _c.c_void_p, _c.c_void_p,                  # v8t, sv
            _c.c_void_p,                               # o
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_float, _c.c_int, _c.c_void_p]),       # scale_log2, dtype, stream
        "obt_int8_flash_attn": (_c.c_int, [
            _c.c_void_p, _c.c_void_p,                  # q8, sq
            _c.c_void_p, _c.c_void_p,                  # k8, sk
            _c.c_void_p, _c.c_void_p,                  # v8t, sv
            _c.c_void_p, _c.c_void_p,                  # seg, o
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_float, _c.c_int, _c.c_void_p]),       # scale_log2, dtype, stream
        "obt_int8_flash_fwd_dots": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q8, k8, v8t
            _c.c_void_p,                               # o
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_void_p]),                             # stream
        "obt_int8_flash_fwd_smem_bytes": (_c.c_int, [_c.c_int]),
        "obt_cuda_error_string_int8": (_c.c_char_p, [_c.c_int]),
    },
    "roofline_probes": {
        "obt_roofline_dots": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p,                               # o
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_int, _c.c_int, _c.c_int,              # kt, cta_q, persistent
            _c.c_void_p]),                             # stream
        "obt_roofline_dots_n": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, v
            _c.c_void_p,                               # o
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_int, _c.c_int, _c.c_int,              # block_q, block_kv, n_dots
            _c.c_int, _c.c_int, _c.c_void_p]),         # cta_q, persistent, stream
        "obt_roofline_scores": (_c.c_int, [
            _c.c_void_p, _c.c_void_p, _c.c_void_p,     # q, k, o
            _c.c_int, _c.c_int, _c.c_int, _c.c_int,    # B, T, H, D
            _c.c_int, _c.c_int, _c.c_int,              # block_kv, kt, cta_q
            _c.c_void_p]),                             # stream
        "obt_roofline_tile": (_c.c_int, [_c.c_int]),
        "obt_cuda_error_string_roofline": (_c.c_char_p, [_c.c_int]),
    },
}

_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); the kernels "
                           "build with nvcc on a host with the toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _so_path(name)
    src = os.path.join(SRC_DIR, f"{name}.cu")
    deps = [src] + [os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                    if f.endswith(".cuh")]
    return (not os.path.exists(so)
            or os.path.getmtime(so) < max(os.path.getmtime(d) for d in deps))


def build_all(names: List[str] = None, verbose: bool = False) -> Dict[str, str]:
    """Compile the named kernels (default: all), one nvcc process per
    source, all started together. Returns {name: compiler output}; raises
    with the compiler's output if any build fails."""
    names = list(_SIGNATURES) if names is None else names
    todo = [n for n in names if _stale(n)]
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = f"{_so_path(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, *_NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(SRC_DIR, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, p) in procs.items():
        logs[n] = p.communicate()[0]
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, _so_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if it is missing or
    older than its sources."""
    lib = _libs.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(_so_path(name))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _libs[name] = lib
    return lib
