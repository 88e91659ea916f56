"""The port's UnitLM against the JAX package's on one checkpoint, in float32
on the CPU: checkpoints cross-load both ways, `log_likelihood` matches,
greedy `generate` gives the same tokens, the sampling warpers give the same
masked logits, and the kwarg surface fails loudly.

Tolerances: 1e-4 on log likelihoods (float32 two-layer forward, summation
order differs); tokens and masks exactly; warped logits 1e-5 (one division
and a softmax over 502 ids).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.config.node import ConfigNode
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.tokeniser.unit_tokeniser import pad_token_batch
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, tlm_factory
from slamkit_tpu_torch.models.generate import NEG_INF, _sample, warp_logits

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

jax_generate = importlib.import_module("slamkit_tpu.models.generate")

SMALL_QWEN = dict(
    base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502, twist_init=False,
    torch_dtype="float32", rope_theta=10000,
    config_overrides=dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=16, intermediate_size=128))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A checkpoint written by the JAX package's save_pretrained, with the
    biases and norm scales perturbed away from their init values."""
    path = tmp_path_factory.mktemp("jax_ckpt")
    model = JaxUnitLM(JaxUnitLMConfig(**SMALL_QWEN), seed=3)
    rng = np.random.default_rng(0)
    layers = dict(model.params["layers"])
    for k in ("q_b", "k_b", "v_b", "attn_norm_scale", "mlp_norm_scale"):
        base = 1.0 if k.endswith("scale") else 0.0
        layers[k] = jnp.asarray(base + 0.1 * rng.standard_normal(layers[k].shape),
                                jnp.float32)
    model.params = {**model.params, "layers": layers}
    model.save_pretrained(str(path))
    return str(path)


def _prompts(seed, lens, vocab=502):
    rng = np.random.default_rng(seed)
    seqs = [[1] + rng.integers(2, vocab, n - 1).tolist() for n in lens]
    return pad_token_batch(seqs, 0, "left")["input_ids"]


def test_jax_checkpoint_loads_and_port_checkpoint_loads_in_jax(ckpt, tmp_path):
    port = UnitLM.from_pretrained(ckpt, device="cpu")
    ref = JaxUnitLM.from_pretrained(ckpt)
    assert port.config.to_dict() == ref.config.to_dict()
    port.save_pretrained(str(tmp_path))
    back = JaxUnitLM.from_pretrained(str(tmp_path))
    flat = np.load(f"{ckpt}/params.npz")
    flat_back = np.load(f"{tmp_path}/params.npz")
    assert sorted(flat.files) == sorted(flat_back.files)
    for k in flat.files:
        np.testing.assert_array_equal(flat[k], flat_back[k], err_msg=k)
    assert back.config.to_dict() == ref.config.to_dict()


@pytest.mark.parametrize("mean_nll", [True, False])
@pytest.mark.parametrize("ignore", [None, [5, 7, 11]])
def test_log_likelihood_matches_jax(ckpt, mean_nll, ignore):
    """T = 70 (not a multiple of 64) with right pads of different lengths."""
    rng = np.random.default_rng(1)
    lens = [70, 41, 12]
    tokens = np.zeros((3, 70), np.int32)
    for i, n in enumerate(lens):
        row = rng.integers(12, 502, n)            # ignored ids never targets
        row[0], row[-1] = 1, 1                    # <S> ... <S>
        tokens[i, :n] = row
    want = np.asarray(JaxUnitLM.from_pretrained(ckpt).log_likelihood(
        tokens, mean_nll=mean_nll, ignore_tokens=ignore))
    got = UnitLM.from_pretrained(ckpt, device="cpu").log_likelihood(
        tokens, mean_nll=mean_nll, ignore_tokens=ignore)
    assert got.shape == (3,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(bad_words_ids=[[7], [9], 30]),
    dict(repetition_penalty=1.3),
])
def test_greedy_generate_matches_jax(ckpt, kwargs):
    prompt = _prompts(2, [9, 5, 13])              # ragged, LEFT-padded
    want = np.asarray(JaxUnitLM.from_pretrained(ckpt).generate(
        prompt, max_new_tokens=20, do_sample=False, seed=0, **kwargs))
    got = UnitLM.from_pretrained(ckpt, device="cpu").generate(
        prompt, max_new_tokens=20, do_sample=False, seed=0, **kwargs)
    assert got.shape == (3, 13 + 20)
    np.testing.assert_array_equal(got.numpy(), want)
    if "bad_words_ids" in kwargs:
        assert not np.isin(got[:, 13:].numpy(), [7, 9, 30]).any()


def test_greedy_generate_pads_after_eos_like_jax(ckpt):
    """eos set to a token row 0 emits early: every row pads after its eos."""
    prompt = _prompts(4, [6, 11])
    free = np.asarray(JaxUnitLM.from_pretrained(ckpt).generate(
        prompt, max_new_tokens=12, do_sample=False))
    eos = int(free[0, 11 + 2])
    want = np.asarray(JaxUnitLM.from_pretrained(ckpt, eos_token_id=eos).generate(
        prompt, max_new_tokens=12, do_sample=False))
    got = UnitLM.from_pretrained(ckpt, eos_token_id=eos, device="cpu").generate(
        prompt, max_new_tokens=12, do_sample=False).numpy()
    np.testing.assert_array_equal(got, want)
    gen = got[:, 11:]
    for row in gen:
        hits = np.where(row == eos)[0]
        if len(hits):
            assert (row[hits[0] + 1:] == 0).all()
    assert (gen[0, 3:] == 0).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, 25, None), (None, None, 0.9), (0.7, 50, 0.8), (None, 10_000, None),
    (1.3, None, 0.95),
])
def test_warpers_match_jax_sample(monkeypatch, temperature, top_k, top_p):
    """The logits JAX `_sample` hands to `jax.random.categorical` equal the
    port's `warp_logits` (masked ids at NEG_INF exactly, the rest 1e-5)."""
    logits = (np.random.default_rng(5).standard_normal((4, 502)) * 2).astype(np.float32)
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jax_generate._sample(jnp.asarray(logits), jax.random.PRNGKey(0), True,
                         temperature, top_k, top_p)
    want = seen["logits"]
    got = warp_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(got == NEG_INF, want == np.float32(NEG_INF))
    keep = want != np.float32(NEG_INF)
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-5, rtol=1e-5)


def test_sampling_draws_are_seeded_and_in_support():
    logits = torch.from_numpy(
        (np.random.default_rng(6).standard_normal((64, 502)) * 2).astype(np.float32))
    warped = warp_logits(logits, 0.8, 25, None)

    def draw(seed):
        return _sample(logits, torch.Generator().manual_seed(seed), True, 0.8, 25, None)

    a, b, c = draw(0), draw(0), draw(1)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert (warped.gather(1, a[:, None]) > NEG_INF).all()


def test_generate_sampling_is_reproducible_per_generator(ckpt):
    lm = UnitLM.from_pretrained(ckpt, device="cpu")
    prompt = _prompts(7, [8, 4])
    run = lambda seed: lm.generate(prompt, max_new_tokens=10, temperature=0.8, top_k=25,
                                   generator=torch.Generator().manual_seed(seed))
    assert torch.equal(run(3), run(3))
    assert torch.equal(lm.generate(prompt, max_new_tokens=10, seed=3, temperature=0.8,
                                   top_k=25), run(3))


def test_generate_kwarg_surface(ckpt):
    lm = UnitLM.from_pretrained(ckpt, device="cpu")
    prompt = np.array([[1, 5, 6, 7]], np.int32)
    assert torch.equal(lm.generate(prompt, max_new_tokens=0), torch.from_numpy(prompt))
    out = lm.generate(prompt, max_new_tokens=2, seed=0, num_beams=1, use_cache=True,
                      length_penalty=1.0, early_stopping=False)
    assert out.shape == (1, 6)
    for bad in (dict(num_beams=4), dict(num_beams=True), dict(early_stopping=0),
                dict(totally_unknown_knob=3)):
        with pytest.raises(ValueError, match=next(iter(bad))):
            lm.generate(prompt, max_new_tokens=2, **bad)
    out = lm.generate(prompt, max_new_tokens=2, seed=0, weight_quant="int8")
    assert out.shape == (1, 6) and torch.equal(out[:, :4], torch.from_numpy(prompt))
    with pytest.raises(ValueError, match="weight_quant"):
        lm.generate(prompt, max_new_tokens=2, weight_quant="fp4")


def test_tlm_factory_gslm_and_pretrained(ckpt):
    args = {**SMALL_QWEN, **SMALL_QWEN["config_overrides"]}
    del args["config_overrides"]
    fresh = tlm_factory(ConfigNode({"tlm_type": "gslm", "pretrained_model": None,
                                    "config_args": args}), device="cpu")
    assert fresh.decoder.cfg.num_layers == 2 and fresh.decoder.cfg.hidden_size == 64
    loaded = tlm_factory(ConfigNode({"tlm_type": "twist", "pretrained_model": ckpt,
                                     "config_args": {"torch_dtype": "float32"}}), device="cpu")
    ref = UnitLM.from_pretrained(ckpt, device="cpu")
    for a, b in zip(loaded.decoder.parameters(), ref.decoder.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="tlm type"):
        tlm_factory(ConfigNode({"tlm_type": "bogus", "config_args": {}}))
