"""A stand-in for the reference OmniBioTE training code, for the checkpoint
migration's fixtures: its persistent RoPE buffer (`precompute_freqs_cis`)
and a `model.py` with its module tree and state_dict names, whose head is
`from mup import MuReadout` as the reference's is. The reference's own
`training/model.py` is not in the repository, so a whole pickled module is
made of this class.

torch only (no jax, nothing of omnibiote_tpu): `tests/test_torch_reference_checkpoint.py`
and `chip_smoke.py` phase 21 both build their `.pt` fixtures with it.
"""
import contextlib
import importlib
import os
import sys

import torch

from omnibiote_tpu_torch.utils.torch_convert import _mup_stub

MODEL_PY = '''
import torch
import torch.nn as nn
from mup import MuReadout


class OmniBioTAConfig:
    def __init__(self, **kw):
        self.__dict__.update(kw)


class CausalSelfAttention(nn.Module):
    def __init__(self, config):
        super().__init__()
        d = config.n_embd
        self.c_attn = nn.Linear(d, 3 * d, bias=config.bias)
        self.c_proj = nn.Linear(d, d, bias=config.bias)
        self.register_buffer("freqs_cis", torch.zeros(
            config.block_size, d // config.n_head // 2, dtype=torch.complex64))


class MLP(nn.Module):
    def __init__(self, config):
        super().__init__()
        d = config.n_embd
        self.c_fc = nn.Linear(d, 4 * d, bias=config.bias)
        self.c_proj = nn.Linear(4 * d, d, bias=config.bias)


class Block(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.ln_1 = nn.LayerNorm(config.n_embd, bias=config.bias)
        self.attn = CausalSelfAttention(config)
        self.ln_2 = nn.LayerNorm(config.n_embd, bias=config.bias)
        self.mlp = MLP(config)


class OmniBioTA(nn.Module):
    def __init__(self, config):
        super().__init__()
        self.config = config
        self.transformer = nn.ModuleDict(dict(
            wte=nn.Embedding(config.vocab_size, config.n_embd),
            h=nn.ModuleList([Block(config) for _ in range(config.n_layer)]),
            ln_f=nn.LayerNorm(config.n_embd, bias=config.bias)))
        self.lm_head = MuReadout(config.n_embd, config.vocab_size, bias=False)
'''


def precompute_freqs_cis(dim, end, theta=10000.0):
    """The reference's persistent RoPE buffer: e^{i t theta^(-2j/dim)},
    (end, dim / 2) complex64."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2)[: dim // 2].float() / dim))
    t = torch.arange(end, dtype=torch.float32)
    freqs = torch.outer(t, freqs).float()
    return torch.polar(torch.ones_like(freqs), freqs)


@contextlib.contextmanager
def modules_restored(*names):
    """Put sys.modules entries `names` back as they were: a pickled
    module's `model` and the `mup` stub must not leak into the rest of the
    process."""
    saved = {n: sys.modules.get(n) for n in names}
    try:
        yield
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def save_pickled_module(state, root, pt, **config):
    """torch.save of a whole stand-in module holding `state`, its class in
    root/model.py and its head a `mup` stub's MuReadout, as the reference
    saves a model; config: the reference config's fields. Returns pt."""
    root = str(root)
    with open(os.path.join(root, "model.py"), "w") as f:
        f.write(MODEL_PY)
    with modules_restored("model", "mup"):
        sys.modules["mup"] = _mup_stub()
        sys.path.insert(0, root)
        try:
            ref = importlib.import_module("model")
        finally:
            sys.path.remove(root)
        m = ref.OmniBioTA(ref.OmniBioTAConfig(**config))
        m.load_state_dict(state, strict=True)
        torch.save(m, pt)
    return pt
