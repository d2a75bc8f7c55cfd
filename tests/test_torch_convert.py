"""Reference-checkpoint migration: .pt file -> omnibiote_tpu checkpoint dir.

The reference saves whole pickled modules (train_encoder.py:412:
torch.save(model.module, ...)). These tests exercise the converter CLI
against a REAL pickled reference module (built by tests/reference_oracle)
and against a bare state_dict (config inferred from shapes + the freqs_cis
RoPE buffer), ending in load_model_checkpoint + fp32 forward parity.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from omnibiote_tpu import forward
from omnibiote_tpu.utils.torch_convert import (
    infer_config_from_torch_state, load_torch_checkpoint, main,
    params_from_torch_state, strip_prefixes)

from reference_oracle import build_reference

CFG_KW = dict(block_size=64, vocab_size=128, n_layer=2, n_head=4, n_embd=32,
              dropout=0.1, bias=False, autoregressive=False,
              checkpoint_freq=0)


def _logits_parity(params, cfg, ref_m):
    cfg = cfg.replace(attn_impl="xla", compute_dtype="float32",
                      param_dtype="float32", dropout=0.0)
    idx = np.random.default_rng(1).integers(
        4, CFG_KW["vocab_size"], size=(2, 48)).astype(np.int32)
    with torch.no_grad():
        ref = ref_m(torch.from_numpy(idx.astype(np.int64))).numpy()
    ours = np.asarray(forward(jax.tree.map(jnp.asarray, params), cfg,
                              jnp.asarray(idx)))
    np.testing.assert_allclose(ours, ref, atol=5e-4)


def test_pickled_module_checkpoint(tmp_path):
    """The reference's own save format: torch.save(module). Config is taken
    from the pickled module's .config; weights land in our pytree with
    forward parity."""
    ref_m, _ = build_reference(CFG_KW, seed=3)
    pt = str(tmp_path / "omnibiota_12345.pt")
    torch.save(ref_m, pt)

    params, cfg = load_torch_checkpoint(
        pt, reference_path="/root/reference",
        mup_base_n_embd=CFG_KW["n_embd"])  # oracle stubs MuReadout: no µP
    assert (cfg.n_layer, cfg.n_head, cfg.n_embd) == (2, 4, 32)
    assert cfg.block_size == 64 and cfg.vocab_size == 128 and not cfg.bias
    assert cfg.dropout == 0.0  # inference-time default, not the training 0.1
    _logits_parity(params, cfg, ref_m)


def test_bare_state_dict_inference(tmp_path):
    """A bare (or 'model'-wrapped, DDP-prefixed) state_dict: every config
    field is recovered from shapes — block_size and n_head via the
    persistent freqs_cis buffer (reference model.py:90)."""
    ref_m, _ = build_reference(CFG_KW, seed=4)
    state = ref_m.state_dict()
    assert "transformer.h.0.attn.freqs_cis" in state  # inference relies on it

    cfg = infer_config_from_torch_state(state)
    assert (cfg.block_size, cfg.vocab_size, cfg.n_layer,
            cfg.n_head, cfg.n_embd, cfg.bias) == (64, 128, 2, 4, 32, False)
    assert cfg.mup_base_n_embd == 24  # the reference's set_base_shapes width

    # DDP-style wrapping + 'model' key, as user-side trainers produce
    wrapped = {"model": {("module." + k): v for k, v in state.items()},
               "step": 7}
    pt = str(tmp_path / "wrapped.pt")
    torch.save(wrapped, pt)
    params, cfg2 = load_torch_checkpoint(pt,
                                         mup_base_n_embd=CFG_KW["n_embd"])
    assert (cfg2.n_layer, cfg2.n_head, cfg2.n_embd) == (2, 4, 32)
    _logits_parity(params, cfg2, ref_m)


def test_cli_convert_then_load_model_checkpoint(tmp_path):
    """python -m omnibiote_tpu.utils.torch_convert <pt> <dir> produces a
    directory every eval entry point can load."""
    from omnibiote_tpu.training.checkpoint import load_model_checkpoint

    ref_m, _ = build_reference(CFG_KW, seed=5)
    pt = str(tmp_path / "ref.pt")
    torch.save(ref_m, pt)
    out = str(tmp_path / "converted")
    main([pt, out, "--reference_path", "/root/reference",
          "--mup_base_n_embd", str(CFG_KW["n_embd"])])

    params, cfg = load_model_checkpoint(out)
    assert cfg.n_embd == 32 and cfg.n_layer == 2
    want = params_from_torch_state(strip_prefixes(ref_m.state_dict()), cfg)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(
            jax.tree.map(jnp.asarray, want))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _logits_parity(params, cfg, ref_m)
