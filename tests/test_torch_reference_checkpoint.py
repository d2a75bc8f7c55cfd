"""PyTorch port vs the JAX package: moving a reference OmniBioTE checkpoint
(.pt) into the system (`omnibiote_tpu_torch/utils/torch_convert.py` against
`omnibiote_tpu/utils/torch_convert.py`), on the CPU.

The fixtures are seeded states in the reference's state_dict layout, with
the persistent RoPE buffers `freqs_cis` built as the reference's
precompute_freqs_cis builds them, at 2 layers: width 32 with 4 heads of 8
and no biases, and width 256 with 2 heads of 128 and biases. They are
saved as a bare state_dict, wrapped under 'model' / 'state_dict' /
'model_state_dict' with 'module.' and '_orig_mod.' prefixes, in bf16, and
as a whole pickled module of the stand-in class of
`tests/reference_standin.py` (a `model.py` that imports `MuReadout` from
`mup`, as the reference's does). Both
packages' converters read each one to the same config and the same
parameters bit for bit, and write the same checkpoint directory; each
package's `load_model_checkpoint` reads the other's; the port's model from
the converted directory meets the JAX forward at rtol 2e-4 / atol 2e-5
(tests/test_model_parity.py's bar) in fp32, as its `Encoder` meets the
JAX `Encoder`.
"""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnibiote_tpu as obt
from omnibiote_tpu import mup as jax_mup
from omnibiote_tpu.api import Encoder as JaxEncoder
from omnibiote_tpu.training.checkpoint import load_model_checkpoint as jax_load_checkpoint
from omnibiote_tpu.utils import torch_convert as jax_tc

from omnibiote_tpu_torch import api as port_api
from omnibiote_tpu_torch import mup as port_mup
from omnibiote_tpu_torch.models.omnibiota import OmniBioTA, encode, forward
from omnibiote_tpu_torch.models.rope import rope_tables
from omnibiote_tpu_torch.tokenizer import train_bpe
from omnibiote_tpu_torch.training.checkpoint import load_model_checkpoint
from omnibiote_tpu_torch.utils import torch_convert as port_tc
from omnibiote_tpu_torch.utils.convert import flatten_tree, jax_params_from_state, torch_leaf_map
from reference_standin import modules_restored, precompute_freqs_cis, save_pickled_module

RTOL, ATOL = 2e-4, 2e-5
V, BLOCK, L = 256, 64, 2
# (width, heads, bias): head dims 8 and 128
CONFIGS = {"d32h4": (32, 4, False), "d256h2": (256, 2, True)}
SPECIALS = ["<EOS>", "<DNA>", "<protein>"]
SEQS = ["<DNA>ACGTACGTAGGCT", "<protein>MKVLAAGIWQRST", "<DNA>" + "ACGTTGCA" * 6,
        "<protein>" + "MKWVTFISLL" * 4, "<DNA>GATTACA"]


def reference_state(name, seed=0):
    """A seeded state_dict in the reference layout (fp32, freqs_cis
    buffers included)."""
    D, H, bias = CONFIGS[name]
    rng = np.random.default_rng(seed)
    t = lambda *shape, s=0.02: torch.from_numpy((rng.standard_normal(shape) * s)
                                                .astype(np.float32))
    ln = lambda: torch.from_numpy((1.0 + 0.1 * rng.standard_normal(D)).astype(np.float32))
    state = {"transformer.wte.weight": t(V, D, s=0.5)}
    for i in range(L):
        p = f"transformer.h.{i}."
        state.update({p + "ln_1.weight": ln(), p + "attn.c_attn.weight": t(3 * D, D),
                      p + "attn.c_proj.weight": t(D, D), p + "ln_2.weight": ln(),
                      p + "mlp.c_fc.weight": t(4 * D, D), p + "mlp.c_proj.weight": t(D, 4 * D),
                      p + "attn.freqs_cis": precompute_freqs_cis(D // H, BLOCK)})
        if bias:
            state.update({p + "ln_1.bias": t(D), p + "ln_2.bias": t(D),
                          p + "attn.c_attn.bias": t(3 * D), p + "attn.c_proj.bias": t(D),
                          p + "mlp.c_fc.bias": t(4 * D), p + "mlp.c_proj.bias": t(D)})
    state["transformer.ln_f.weight"] = ln()
    if bias:
        state["transformer.ln_f.bias"] = t(D)
    state["lm_head.weight"] = t(V, D, s=0.5)
    return state


def _save_pickled_module(state, name, root):
    """torch.save of a whole stand-in module holding `state`; returns the
    .pt path."""
    D, H, bias = CONFIGS[name]
    return save_pickled_module(state, root, str(root / "omnibiota_12345.pt"),
                               block_size=BLOCK, vocab_size=V, n_layer=L, n_head=H,
                               n_embd=D, bias=bias, dropout=0.1)


def _write_format(fmt, state, name, root):
    """The .pt of `state` in format `fmt`; returns (path, reference_path)."""
    pt = str(root / f"{fmt}.pt")
    if fmt == "bare":
        torch.save(state, pt)
    elif fmt == "bf16":
        torch.save({k: (v.bfloat16() if v.is_floating_point() else v)
                    for k, v in state.items()}, pt)
    elif fmt == "pickled_module":
        return _save_pickled_module(state, name, root), str(root)
    else:   # a wrapper key, with DDP / compile prefixes
        prefix = "module._orig_mod." if fmt == "model" else (
            "module." if fmt == "state_dict" else "_orig_mod.")
        torch.save({fmt: {prefix + k: v for k, v in state.items()}, "step": 7}, pt)
    return pt, ""


def _load_both(pt, reference_path):
    with modules_restored("model", "mup"):
        jparams, jcfg = jax_tc.load_torch_checkpoint(pt, reference_path=reference_path)
    with modules_restored("model", "mup"):
        pstate, pcfg = port_tc.load_torch_checkpoint(pt, reference_path=reference_path)
    return (jparams, jcfg), (pstate, pcfg)


def _same_bits(a, b):
    a, b = np.ascontiguousarray(np.asarray(a)), np.ascontiguousarray(np.asarray(b))
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _assert_same_tree(port_tree, jax_tree):
    got = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
           for k, v in flatten_tree(port_tree).items()}
    want = {k: np.asarray(v) for k, v in flatten_tree(jax_tree).items()}
    assert sorted(got) == sorted(want)
    bad = [k for k in want if not _same_bits(got[k], want[k])]
    assert not bad, bad


@pytest.mark.parametrize("name", list(CONFIGS))
def test_strip_prefixes_and_infer_config_match_jax(name):
    state = reference_state(name)
    wrapped = {("module._orig_mod." if i % 2 else "module.module.") + k: v
               for i, (k, v) in enumerate(state.items())}
    got, want = port_tc.strip_prefixes(wrapped), jax_tc.strip_prefixes(wrapped)
    assert list(got) == list(want) == list(state)
    assert all(got[k] is want[k] for k in got)
    # 'module.' is dropped before '_orig_mod.', in both
    odd = {"_orig_mod.module.x": 1, "_orig_mod._orig_mod.y": 2}
    assert port_tc.strip_prefixes(odd) == jax_tc.strip_prefixes(odd) == {"module.x": 1, "y": 2}
    for kw in ({}, {"mup_base_n_embd": 48, "dropout": 0.1}):
        pcfg = port_tc.infer_config_from_torch_state(state, **kw)
        jcfg = jax_tc.infer_config_from_torch_state(state, **kw)
        assert vars(pcfg) == vars(jcfg)
    D, H, bias = CONFIGS[name]
    assert (pcfg.n_layer, pcfg.n_embd, pcfg.n_head, pcfg.block_size, pcfg.vocab_size,
            pcfg.bias) == (L, D, H, BLOCK, V, bias)


@pytest.mark.parametrize("fmt", ["bare", "model", "state_dict", "model_state_dict", "bf16",
                                 "pickled_module"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_every_format_loads_as_jax_loads_it(tmp_path, name, fmt):
    """Both converters read each format to the same config and the same
    parameters bit for bit; the port's state is what OmniBioTA takes."""
    state = reference_state(name, seed=1)
    pt, ref_path = _write_format(fmt, state, name, tmp_path)
    (jparams, jcfg), (pstate, pcfg) = _load_both(pt, ref_path)
    assert vars(pcfg) == vars(jcfg) and pcfg.dropout == 0.0
    assert sorted(pstate) == sorted(torch_leaf_map(pcfg))
    assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in pstate.values())
    _assert_same_tree(jax_params_from_state(pstate, pcfg), jparams)
    if fmt != "bf16":
        assert all(torch.equal(pstate[k], state[k]) for k in pstate)
    OmniBioTA(pcfg, device="cpu").load_state_dict(pstate, strict=True)


def test_unsupported_object_raises_in_both(tmp_path):
    pt = str(tmp_path / "list.pt")
    torch.save([1, 2, 3], pt)
    for load in (jax_tc.load_torch_checkpoint, port_tc.load_torch_checkpoint):
        with modules_restored("model", "mup"), \
                pytest.raises(ValueError, match="unsupported checkpoint object"):
            load(pt)


@pytest.fixture(scope="module", params=list(CONFIGS))
def converted(request, tmp_path_factory):
    """(name, the .pt, the JAX main's directory and summary line, the
    port main's)."""
    import io
    from contextlib import redirect_stdout

    name = request.param
    root = tmp_path_factory.mktemp(f"convert_{name}")
    pt = str(root / "ref.pt")
    torch.save({"model": {"module." + k: v for k, v in reference_state(name, 2).items()}}, pt)
    out = {}
    for pkg, main in (("jax", jax_tc.main), ("port", port_tc.main)):
        d = str(root / pkg)
        buf = io.StringIO()
        with modules_restored("model", "mup"), redirect_stdout(buf):
            main([pt, d, "--mup_base_n_embd", "24"])
        out[pkg] = (d, buf.getvalue().replace(d, "OUT"))
    return name, pt, out


def _npz(path):
    with np.load(os.path.join(path, "params.npz")) as z:
        return {k: z[k] for k in z.files}


def _meta(path):
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def test_both_mains_write_the_same_directory(converted):
    _, _, out = converted
    (jdir, jline), (pdir, pline) = out["jax"], out["port"]
    assert pline == jline and pline.startswith("converted ")
    jz, pz = _npz(jdir), _npz(pdir)
    assert sorted(jz) == sorted(pz)
    assert all(_same_bits(pz[k], jz[k]) for k in jz)
    assert _meta(pdir) == _meta(jdir)
    assert _meta(pdir)["converted_from"] == "reference torch checkpoint"


def test_each_load_model_checkpoint_reads_the_others(converted):
    _, _, out = converted
    jdir, pdir = out["jax"][0], out["port"][0]
    jparams, jcfg = jax_load_checkpoint(pdir)
    want, _ = jax_load_checkpoint(jdir)
    assert jax.tree.structure(jparams) == jax.tree.structure(want)
    assert all(_same_bits(a, b) for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(want)))
    model, pcfg = load_model_checkpoint(jdir, device="cpu")
    mine, _ = load_model_checkpoint(pdir, device="cpu")
    assert vars(pcfg) == vars(jcfg)
    ms = mine.state_dict()
    assert all(torch.equal(v, ms[k]) for k, v in model.state_dict().items())


def _fp32(cfg):
    return cfg.replace(compute_dtype="float32", dropout=0.0)


def test_converted_model_matches_jax_forward(converted):
    """fp32 logits and encode(mean) of the port's model from the converted
    directory against the JAX forward on the JAX converter's params."""
    _, pt, out = converted
    with modules_restored("model", "mup"):
        jparams, jcfg = jax_tc.load_torch_checkpoint(pt)
    jcfg = _fp32(jcfg).replace(attn_impl="xla")
    jparams = jax.tree.map(jnp.asarray, jparams)
    model, cfg = load_model_checkpoint(out["port"][0], device="cpu")
    model.cfg = _fp32(cfg)
    idx = np.random.default_rng(3).integers(4, V, size=(2, 48)).astype(np.int32)
    want = np.asarray(obt.forward(jparams, jcfg, jnp.asarray(idx)))
    with torch.no_grad():
        got = forward(model, torch.from_numpy(idx).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    want = np.asarray(obt.encode(jparams, jcfg, jnp.asarray(idx), "mean"))
    got = encode(model, torch.from_numpy(idx).long(), "mean").numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_coord_check_stats_matches_jax(converted):
    """mup.coord_check_stats on the converted weights: mean |final
    embeddings| of the port's model against the JAX helper's."""
    _, pt, out = converted
    with modules_restored("model", "mup"):
        jparams, jcfg = jax_tc.load_torch_checkpoint(pt)
    jcfg = _fp32(jcfg).replace(attn_impl="xla")
    model, cfg = load_model_checkpoint(out["port"][0], device="cpu")
    model.cfg = _fp32(cfg)
    idx = np.random.default_rng(4).integers(4, V, size=(2, 32)).astype(np.int32)
    want = jax_mup.coord_check_stats(jax.tree.map(jnp.asarray, jparams), jcfg, obt.forward,
                                     jnp.asarray(idx))
    got = port_mup.coord_check_stats(model, torch.from_numpy(idx).long())
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_encoder_from_converted_directory_matches_jax(converted, tmp_path):
    """Encoder.from_checkpoint(dir, device='cpu') on the converted
    directory (its compute dtype set to fp32 for the comparison) against
    the JAX Encoder on the same directory, every pooling."""
    import shutil

    _, _, out = converted
    d = str(tmp_path / "fp32")
    shutil.copytree(out["port"][0], d)
    meta = _meta(d)
    meta["model_cfg"]["compute_dtype"] = "float32"
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(meta, f)
    tok = str(tmp_path / "toy.model")
    rng = np.random.default_rng(0)
    corpus = [("<protein>" + "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 40))
               if i % 2 else "<DNA>" + "".join(rng.choice(list("ACGT"), 40))) + "<EOS>"
              for i in range(200)]
    train_bpe(corpus, vocab_size=200, out_path=tok, user_defined=SPECIALS)
    jenc = JaxEncoder.from_checkpoint(d, tokenizer_path=tok)
    penc = port_api.Encoder.from_checkpoint(d, tokenizer_path=tok, device="cpu")
    for method in ("mean", "first", "last", "max"):
        want = jenc.encode_sequences(SEQS, method=method, batch_size=2)
        got = penc.encode_sequences(SEQS, method=method, batch_size=2)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_fixture_freqs_cis_is_the_ports_rope_tables():
    """The fixtures' RoPE buffer is cos + i·sin of the port's tables (the
    angles of ~63 in fp32 leave ~4e-6 of rounding between the two
    builds)."""
    for name, (D, H, _) in CONFIGS.items():
        fc = reference_state(name)["transformer.h.0.attn.freqs_cis"]
        assert fc.dtype == torch.complex64 and fc.shape == (BLOCK, D // H // 2)
        cos, sin = rope_tables(D // H, BLOCK)
        np.testing.assert_allclose(fc.real.numpy(), cos.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(fc.imag.numpy(), sin.numpy(), rtol=0, atol=1e-5)
