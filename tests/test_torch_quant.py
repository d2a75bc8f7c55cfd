"""PyTorch port vs the JAX package: int8 serving weights (`ops/quant.py`),
the quantized tree's converter, and the quantized model end to end.

Inputs come from a numpy seed and go through both packages. Integers are
compared bit for bit. Where floats are compared the tolerance is stated in
the test."""
import torch_threads  # noqa: F401  (first: one intra-op thread a process)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnibiote_tpu as obt
from omnibiote_tpu.ops import quant as jax_quant

import omnibiote_tpu_torch as port
from omnibiote_tpu_torch.ops import quant as port_quant
from omnibiote_tpu_torch.utils import convert


def _cfgs(bias=False, **kw):
    base = dict(n_layer=2, n_head=2, n_embd=256, block_size=128, vocab_size=512,
                dropout=0.0, attn_impl="xla", compute_dtype="float32",
                mup_base_n_embd=32, bias=bias)
    base.update(kw)
    return obt.OmniBioTAConfig(**base), port.OmniBioTAConfig(**base)


def _jax_params(jcfg, seed=0):
    params = obt.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.bias:
        # non-zero biases so a permutation mismatch would show
        rng = np.random.default_rng(seed + 1)
        blocks = params["blocks"]
        for sub, leaf in (("attn", "bqkv"), ("attn", "bo"), ("mlp", "bi"),
                          ("mlp", "bo")):
            shape = blocks[sub][leaf].shape
            blocks[sub][leaf] = jnp.asarray(
                rng.standard_normal(shape).astype(np.float32) * 0.1)
    return params


def _port_model(params, pcfg):
    model = port.OmniBioTA(pcfg, device="cpu")
    state = convert.state_from_jax_params(
        jax.tree.map(np.asarray, params), pcfg)
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()})
    return model.eval()


def _numpy_tree(qparams):
    return jax.tree.map(np.asarray, qparams)


def _tokens(B, T, hi, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(20, hi, size=(B, T)).astype(np.int32)


def _hold_quantized(got, want):
    """Two runs on identical integers: the fp32 passes between the products
    differ in the last bits, which can flip the rounding of an activation,
    a step of 1/127 of its row's max for one element of one product. Such a
    flip in the first layer moves its token's whole output row by up to
    ~1e-2 at |x| ~ 1 and leaves the other rows alone: every element within
    2e-2, 90 % of them within 2e-3."""
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert diff.max() <= 2e-2, diff.max()
    assert (diff > 2e-3).mean() < 0.1, (diff > 2e-3).mean()


def _row_cosine(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("shape", [(256, 768), (1024, 256), (128, 512)])
def test_quantize_weight_matches_jax_bit_for_bit(shape):
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)      # (fan_in, fan_out)
    w[:, 3] = 0.0                                           # a zero channel
    want = jax_quant.quantize_weight(jnp.asarray(w))
    got = port_quant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert got.values.dtype == torch.int8 and got.values.shape == shape[::-1]
    np.testing.assert_array_equal(got.values.numpy().T, np.asarray(want.values))
    # the same fp32 max and the same fp32 division: held to 1 ulp
    np.testing.assert_array_max_ulp(got.scale.numpy(), np.asarray(want.scale), 1)
    assert got.scale[3].item() == 1.0 and int(got.values.abs().max()) == 127


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_quantize_for_inference_matches_jax_tree(bias):
    """The port's quantized model, as a tree in the JAX layout, equals the
    JAX package's quantized tree: int8 values bit for bit, scales to 1 ulp,
    bqkv permuted alongside, every other leaf untouched."""
    jcfg, pcfg = _cfgs(bias=bias)
    params = _jax_params(jcfg)
    want = _numpy_tree(jax_quant.quantize_for_inference(params, jcfg))
    model = _port_model(params, pcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    qmodel = port_quant.quantize_for_inference(model)
    assert qmodel.cfg.qkv_prepermuted and not model.cfg.qkv_prepermuted
    for k, v in model.state_dict().items():                # input untouched
        assert torch.equal(v, before[k]), k
    assert not any(".weight" in k and ("c_" in k or "lm_head" in k)
                   for k in qmodel.state_dict())           # fp32 weights freed
    got = convert.jax_qparams_from_quantized_state(
        {k: v.numpy() for k, v in qmodel.state_dict().items()}, pcfg)
    n_quantized = 0
    for key, leaf in convert.flatten_tree(got).items():
        node = want
        for part in key.split("/"):
            node = node[part] if isinstance(node, dict) else getattr(node, part)
        if key.endswith("/values"):
            assert leaf.dtype == np.int8
            np.testing.assert_array_equal(leaf, node, err_msg=key)
            n_quantized += 1
        elif key.endswith("/scale") and key.count("/") > 1 or key == "lm_head/scale":
            np.testing.assert_array_max_ulp(leaf, node, 1)
        else:
            np.testing.assert_array_equal(leaf, node, err_msg=key)
    assert n_quantized == 5                                 # wqkv, 2 wo, wi, lm_head
    with pytest.raises(ValueError, match="already permuted"):
        port_quant.quantize_for_inference(qmodel)


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("rows", [(3, 40), (5,), (1, 1)], ids=["3d", "2d", "one_row"])
def test_quant_linear_matches_jax(rows, with_bias):
    """Same x and weight: the int32 accumulators are equal (the output, an
    fp32 rescale of them with the same association, agrees to 1e-6
    relative), whatever the leading shape."""
    rng = np.random.default_rng(len(rows))
    fan_in, fan_out = 256, 384
    x = rng.standard_normal((*rows, fan_in)).astype(np.float32)
    x[0, ..., :] *= 0.0 if len(rows) == 2 else 1.0          # a zero row too
    w = rng.standard_normal((fan_in, fan_out)).astype(np.float32)
    b = rng.standard_normal(fan_out).astype(np.float32) if with_bias else None
    jw = jax_quant.quantize_weight(jnp.asarray(w))
    pw = port_quant.quantize_weight(torch.from_numpy(w.T.copy()))
    want = np.asarray(jax_quant.quant_linear(
        jnp.asarray(x), jw, None if b is None else jnp.asarray(b)))
    got = port_quant.quant_linear(torch.from_numpy(x), pw,
                                  None if b is None else torch.from_numpy(b))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the accumulators themselves, from the same integers
    xf = torch.from_numpy(x).reshape(-1, fan_in)
    s_x = xf.abs().amax(-1, keepdim=True) / 127.0
    x_q = torch.round(xf / torch.where(s_x == 0, 1.0, s_x)).to(torch.int8)
    acc = port_quant._int8_matmul(x_q, pw.values)
    assert acc.dtype == torch.int32
    want_acc = np.asarray(x_q.numpy().astype(np.int32) @ np.asarray(jw.values, np.int32))
    np.testing.assert_array_equal(acc.numpy(), want_acc)


def test_quant_linear_keeps_the_dtype():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32)).bfloat16()
    pw = port_quant.quantize_weight(
        torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)))
    y = port_quant.quant_linear(x, pw)
    assert y.dtype == torch.bfloat16 and y.shape == (4, 64)
    ref = x.float() @ (pw.values.float() * pw.scale[:, None]).t()
    # int8 activations: 1/127 of the row's max per element, summed over 128
    assert torch.allclose(y.float(), ref, rtol=0.05, atol=0.3)


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_quantized_converter_round_trip(bias):
    jcfg, pcfg = _cfgs(bias=bias)
    qparams = _numpy_tree(jax_quant.quantize_for_inference(_jax_params(jcfg), jcfg))
    state = convert.quantized_state_from_jax_params(qparams, pcfg)
    assert state["transformer.h.1.mlp.c_fc.values"].shape == (1024, 256)
    assert state["transformer.h.1.mlp.c_fc.scale"].shape == (1024,)
    assert state["lm_head.values"].shape == (512, 256)
    back = convert.jax_qparams_from_quantized_state(state, pcfg)
    flat = convert.flatten_tree(back)
    assert len(flat) == (16 if bias else 9) + 5            # pairs count twice
    for key, leaf in flat.items():
        node = qparams
        for part in key.split("/"):
            node = node[part] if isinstance(node, dict) else getattr(node, part)
        np.testing.assert_array_equal(leaf, node, err_msg=key)
    # and the state loads into a quantized port model
    model = port_quant.quantize_for_inference(port.OmniBioTA(pcfg, device="cpu"))
    model.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()})


@pytest.fixture(scope="module", params=[False, True], ids=["nobias", "bias"])
def quantized_pair(request):
    """(jax params, jax qparams, jax qcfg, port fp32 model, port quantized
    model holding the JAX package's own integers, tokens)."""
    jcfg, pcfg = _cfgs(bias=request.param)
    params = _jax_params(jcfg)
    qparams = jax_quant.quantize_for_inference(params, jcfg)
    model = _port_model(params, pcfg)
    qmodel = port_quant.quantize_for_inference(model)
    state = convert.quantized_state_from_jax_params(_numpy_tree(qparams), pcfg)
    qmodel.load_state_dict({k: torch.from_numpy(np.array(v))
                            for k, v in state.items()})
    return (params, qparams, jcfg, jcfg.replace(qkv_prepermuted=True), model,
            qmodel, _tokens(4, 128, 500))


def test_quantized_encode_matches_jax(quantized_pair):
    """Identical integers in both packages. The fp32 passes between the
    products differ in the last bits, which can flip the rounding of an
    activation (1/127 of its row's max for one element); embeddings are
    held to 2e-3 absolute at |e| ~ 1 and to a row cosine of 0.99999. Vs the
    fp32 model: the JAX tests' bar, cosine > 0.99."""
    params, qparams, jcfg, qcfg, model, qmodel, toks = quantized_pair
    want = np.asarray(obt.encode(qparams, qcfg, jnp.asarray(toks), "mean"))
    got = port.encode(qmodel, torch.from_numpy(toks), "mean").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    assert _row_cosine(got, want).min() > 0.99999
    ref = port.encode(model, torch.from_numpy(toks), "mean").numpy()
    assert _row_cosine(got, ref).min() > 0.99
    jref = np.asarray(obt.encode(params, jcfg, jnp.asarray(toks), "mean"))
    assert _row_cosine(got, jref).min() > 0.99


def test_quantized_forward_logits_match_jax(quantized_pair):
    """forward() with logits runs on the quantized model (the int8 lm_head):
    vs JAX on the same integers at `_hold_quantized`'s bar and a
    correlation > 0.9999; vs the fp32 logits correlation > 0.99."""
    params, qparams, jcfg, qcfg, model, qmodel, toks = quantized_pair
    want = np.asarray(obt.forward(qparams, qcfg, jnp.asarray(toks)))
    with torch.no_grad():
        got = qmodel(torch.from_numpy(toks)).numpy()
        ref = model(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (4, 128, 512)
    _hold_quantized(got, want)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.9999
    assert np.corrcoef(got.ravel(), ref.ravel())[0, 1] > 0.99


def test_quantized_model_with_segments(quantized_pair):
    """The masked serving forward (padding segment ids) on the quantized
    model vs JAX, real positions, at `_hold_quantized`'s bar."""
    _, qparams, _, qcfg, _, qmodel, toks = quantized_pair
    seg = np.zeros_like(toks)
    seg[:, 100:] = -1
    want = np.asarray(obt.forward(qparams, qcfg, jnp.asarray(toks),
                                  segment_ids=jnp.asarray(seg),
                                  return_embeddings=True))
    with torch.no_grad():
        got = qmodel(torch.from_numpy(toks), torch.from_numpy(seg),
                     return_embeddings=True).numpy()
    _hold_quantized(got[:, :100], want[:, :100])
