"""The port's int8 weight-only path against the JAX package's, on the CPU:
`quantize_weight` bit for bit, the plain `dq_matmul` against the Pallas
kernel in interpret mode, the int8 decode weights, the int8 prefill logits,
greedy int8 generation, and the decode-weight cache.

Tolerances: quantized values and scales exactly (the same float32 divide,
rounded half to even both sides). The plain dq_matmul multiplies the scale
into the weights before a float32 product, the Pallas kernel multiplies the
float32 sum by it; both products are exact in float32, so only the
summation order differs and the bf16 outputs may round one bf16 ulp apart
(`ops.quant.ulp_bound`, which the card holds the CUDA kernel to as well).
Logits 2e-2: each of a two-layer model's bf16 projection outputs may sit one
ulp (2^-8 relative) apart, which moves float32 logits of size ~3 by ~1e-2 at
most.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.models.generate import _quantize_decode_params as jax_quantize_params
from slamkit_tpu.models.transformer import forward as jax_forward
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.ops import quant as jax_quant
from slamkit_tpu.tokeniser.unit_tokeniser import pad_token_batch
from slamkit_tpu_torch.models import UnitLM
from slamkit_tpu_torch.models.generate import (_QUANT_KEYS, _quantize_decode_params,
                                               _weights, prepare_int8_decode_params)
from slamkit_tpu_torch.ops import (dequantize_weight, dq_matmul, dq_matmul_reference,
                                   quantize_weight)
from slamkit_tpu_torch.ops.quant import ulp_bound

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

SMALL_QWEN = dict(
    base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502, twist_init=False,
    torch_dtype="float32", rope_theta=10000,
    config_overrides=dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=16, intermediate_size=128))


def _bf16_to_f32(a) -> np.ndarray:
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _weight_with_edge_columns(rng, k, n):
    """Random columns, an all-zero column (scale 1), and a column whose
    quotients are exact halves (ties: 2.5 -> 2, 3.5 -> 4, -2.5 -> -2)."""
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    w[:, 1] = 0.0
    w[:, 2] = 0.0
    w[:4, 2] = np.array([127.0, 2.5, 3.5, -2.5], np.float32) * 2.0 ** -7
    return w


@pytest.mark.parametrize("k,n", [(64, 128), (896, 250), (128, 896)])
def test_quantize_weight_bit_exact(k, n):
    w = _weight_with_edge_columns(np.random.default_rng(k + n), k, n)
    q_ref, s_ref = jax_quant.quantize_weight(jnp.asarray(w))
    q, s = quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16 and s.shape == (1, n)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.float().numpy(), _bf16_to_f32(s_ref))
    assert s[0, 1].item() == 1.0 and (q[:, 1] == 0).all()
    assert q[:4, 2].tolist() == [127, 2, 4, -2]
    np.testing.assert_array_equal(
        dequantize_weight(q, s, torch.float32).numpy(),
        np.asarray(jax_quant.dequantize_weight(q_ref, s_ref, jnp.float32)))


@pytest.mark.parametrize("m,k,n", [
    (16, 896, 4864),   # decode rows, MLP up (Slam width)
    (8, 896, 128),     # decode rows, k/v projection
    (3, 896, 896),     # odd row count
    (8, 128, 250),     # N not a multiple of 128
    (600, 128, 256),   # more rows than the Pallas row block (256): its row grid
])
def test_plain_dq_matmul_within_one_ulp_of_pallas(m, k, n):
    rng = np.random.default_rng(m * k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.02).astype(np.float32)
    q, s = jax_quant.quantize_weight(jnp.asarray(w))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = _bf16_to_f32(jax_quant.dq_matmul(xb, q, s, interpret=True))
    got = dq_matmul(torch.from_numpy(_bf16_to_f32(xb)).to(torch.bfloat16),
                    torch.from_numpy(np.asarray(q)), torch.from_numpy(_bf16_to_f32(s)).to(
                        torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    want = torch.from_numpy(want)
    assert bool(((got.float() - want).abs() <= ulp_bound(got, want)).all()), \
        (got.float() - want).abs().max().item()
    assert dq_matmul.launches == 0                 # CPU tensors: the plain version


def test_dq_matmul_refuses_bad_shapes():
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    q, s = quantize_weight(torch.ones((64, 32)))
    with pytest.raises(ValueError, match="disagree on K"):
        dq_matmul(x, q[:32], s)
    with pytest.raises(ValueError, match=r"\[1, N\]"):
        dq_matmul(x, q, s[:, :16])
    with pytest.raises(TypeError, match="int8"):
        dq_matmul(x, q.float(), s)
    torch.testing.assert_close(dq_matmul(x, q, s), dq_matmul_reference(x, q, s))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ckpt_int8")
    JaxUnitLM(JaxUnitLMConfig(**SMALL_QWEN), seed=5).save_pretrained(str(path))
    return str(path)


def test_quantize_decode_params_covers_keys_and_is_idempotent(ckpt):
    dec = UnitLM.from_pretrained(ckpt, device="cpu").decoder
    prepared = prepare_int8_decode_params(dec)
    params = dict(prepared.named_parameters())
    for i, layer in enumerate(prepared.layers):
        for key in _QUANT_KEYS:
            w = getattr(layer, key)
            assert isinstance(w, dict) and w["q"].dtype == torch.int8, key
            assert w["s"].dtype == torch.bfloat16 and w["s"].shape[0] == 1
            assert f"layers.{i}.{key}" not in params
    state = _weights(prepared)
    quantized = {n for n, w in state.items() if isinstance(w, dict)}
    assert len(quantized) == len(_QUANT_KEYS) * len(prepared.layers)
    again = _weights(prepare_int8_decode_params(prepared))
    requantized = _quantize_decode_params(state)
    for name in quantized:
        assert again[name]["q"] is state[name]["q"] and again[name]["s"] is state[name]["s"]
        assert requantized[name] is state[name]
    # embeddings and the norms stay dense
    assert isinstance(prepared.embed, torch.Tensor)
    assert isinstance(prepared.layers[0].attn_norm_scale, torch.Tensor)


def _jax_int8_params(ckpt, **overrides):
    model = JaxUnitLM.from_pretrained(ckpt, **overrides)
    dt = model.decoder.compute_dtype
    cast = jax.tree_util.tree_map(
        lambda x: x.astype(dt) if x.dtype == jnp.float32 and x.ndim > 1 else x, model.params)
    return model, jax_quantize_params(cast)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_weights_match_jax(ckpt, dtype):
    """In bf16 compute both packages quantize the bf16-cast weights (the
    float32 masters would put a few values one int8 step away)."""
    _, qparams = _jax_int8_params(ckpt, torch_dtype=dtype)
    prepared = prepare_int8_decode_params(
        UnitLM.from_pretrained(ckpt, torch_dtype=dtype, device="cpu").decoder)
    for key in _QUANT_KEYS:
        for i, layer in enumerate(prepared.layers):
            w = getattr(layer, key)
            np.testing.assert_array_equal(w["q"].numpy(),
                                          np.asarray(qparams["layers"][key]["q"][i]))
            np.testing.assert_array_equal(w["s"].float().numpy(),
                                          _bf16_to_f32(qparams["layers"][key]["s"][i]))


def test_int8_prefill_logits_match_jax(ckpt):
    model, qparams = _jax_int8_params(ckpt)
    prepared = prepare_int8_decode_params(UnitLM.from_pretrained(ckpt, device="cpu").decoder)
    ids = np.random.default_rng(0).integers(2, 502, (2, 24))
    want, _ = jax_forward(qparams, model.decoder, jnp.asarray(ids))
    with torch.inference_mode():
        got, _ = prepared(torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2, rtol=0)


def test_greedy_int8_generate_matches_jax(ckpt):
    rng = np.random.default_rng(2)
    seqs = [[1] + rng.integers(2, 502, n - 1).tolist() for n in (9, 5, 13)]
    prompt = pad_token_batch(seqs, 0, "left")["input_ids"]
    want = np.asarray(JaxUnitLM.from_pretrained(ckpt).generate(
        prompt, max_new_tokens=8, do_sample=False, seed=0, weight_quant="int8"))
    got = UnitLM.from_pretrained(ckpt, device="cpu").generate(
        prompt, max_new_tokens=8, do_sample=False, seed=0, weight_quant="int8")
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_cache_is_rebuilt_when_weights_change(ckpt):
    lm = UnitLM.from_pretrained(ckpt, device="cpu")
    first = lm._int8_decode_params()
    assert lm._int8_decode_params() is first
    with torch.no_grad():
        lm.decoder.layers[0].q_w.mul_(2.0)             # in place, as an optimizer step
    second = lm._int8_decode_params()
    assert second is not first
    torch.testing.assert_close(second.layers[0].q_w["s"].float(),
                               2 * first.layers[0].q_w["s"].float(), rtol=1e-2, atol=0)
    lm.decoder = UnitLM.from_pretrained(ckpt, device="cpu").decoder  # new parameters
    assert lm._int8_decode_params() is not second
    assert lm._int8_decode_params() is lm._int8_decode_params()


def test_generate_runs_a_prepared_decoder_as_it_is(ckpt, monkeypatch):
    """`generate` prepares int8 weights only for a dense decoder: the copy
    that UnitLM caches goes through unprepared again."""
    import importlib

    gen = importlib.import_module("slamkit_tpu_torch.models.generate")
    prepared = []
    real = gen.prepare_int8_decode_params
    monkeypatch.setattr(gen, "prepare_int8_decode_params",
                        lambda dec: prepared.append(dec) or real(dec))
    lm = UnitLM.from_pretrained(ckpt, device="cpu")
    prompt = np.random.default_rng(6).integers(2, 502, (2, 5))
    kw = dict(max_new_tokens=3, do_sample=False, seed=0, weight_quant="int8")
    first = lm.generate(prompt, **kw)
    torch.testing.assert_close(lm.generate(prompt, **kw), first, rtol=0, atol=0)
    assert prepared == [] and gen.is_int8_prepared(lm._int8_decode_params())
    assert not gen.is_int8_prepared(lm.decoder)
    ids = torch.from_numpy(prompt)
    direct = gen.generate(lm.decoder, ids, torch.ones_like(ids), None, max_new_tokens=3,
                          do_sample=False, weight_quant="int8")
    assert prepared == [lm.decoder] and direct.shape == first.shape


def test_int8_generate_runs_every_projection_through_dq_matmul(ckpt, monkeypatch):
    """Prefill and each of the new_tokens - 1 decode steps run all seven
    projections of every layer through dq_matmul: 7 x layers x new_tokens
    calls (on the card, as many kernel launches); dense generation none."""
    from slamkit_tpu_torch.models import transformer

    calls = []

    def counting(x, q, s):
        calls.append(tuple(q.shape))
        return dq_matmul_reference(x, q, s)

    monkeypatch.setattr(transformer, "dq_matmul", counting)
    lm = UnitLM.from_pretrained(ckpt, device="cpu")
    prompt = np.random.default_rng(4).integers(2, 502, (3, 7))
    lm.generate(prompt, max_new_tokens=5, seed=0)
    assert calls == []
    lm.generate(prompt, max_new_tokens=5, seed=0, weight_quant="int8")
    assert len(calls) == len(_QUANT_KEYS) * len(lm.decoder.layers) * 5
    assert set(calls) == {(64, 64), (64, 32), (64, 128), (128, 64)}
