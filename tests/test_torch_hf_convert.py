"""The port's HF checkpoint path (`slamkit_tpu_torch/models/hf_convert.py`,
the TWIST warm start, reference-toolkit checkpoints, the HF export) against
the JAX package's and against transformers, on tiny models built here with
transformers from a seed (nothing comes from the hub).

Tolerances: converted parameters, the exports' state dicts and the kept
embedding rows exactly; logits against the HF torch model 2e-4 absolute and
1e-3 relative (`tests/test_hf_convert.py`'s bound: two float32 layers whose
sums run in another order); the reference checkpoint's logits against the
JAX package's 1e-4. Fresh embedding rows come from a torch generator, not
`jax.random`: their mean must lie within 3 standard errors of the old
embedding's mean and their spread within 10% of initializer_range.
"""
import dataclasses
import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.config import ConfigNode
from slamkit_tpu.models import hf_convert as jax_hf
from slamkit_tpu.models.presets import config_from_hf_dict as jax_config_from_hf_dict
from slamkit_tpu.models.transformer import DecoderConfig as JaxDecoderConfig
from slamkit_tpu.models.transformer import forward as jax_forward
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu_torch.models import Decoder, UnitLM, UnitLMConfig, load_flat, tlm_factory, to_flat
from slamkit_tpu_torch.models import hf_convert
from slamkit_tpu_torch.models.presets import DecoderConfig, config_from_hf_dict

transformers = pytest.importorskip("transformers")

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

HF_TOL = dict(atol=2e-4, rtol=1e-3)


def _hf_model(family: str, vocab: int = 99, seed: int = 0):
    """(tiny HF causal LM in eval mode, its config dict with model_type)."""
    T = transformers
    common = dict(vocab_size=vocab, num_hidden_layers=2, num_attention_heads=4,
                  max_position_embeddings=128, attn_implementation="eager")
    cfg, cls = {
        "qwen2": lambda: (T.Qwen2Config(hidden_size=32, intermediate_size=64,
                                        num_key_value_heads=2, rope_theta=10000.0,
                                        tie_word_embeddings=True, **common),
                          T.Qwen2ForCausalLM),
        "llama": lambda: (T.LlamaConfig(hidden_size=32, intermediate_size=64,
                                        num_key_value_heads=4, tie_word_embeddings=False,
                                        **common), T.LlamaForCausalLM),
        "opt": lambda: (T.OPTConfig(hidden_size=32, ffn_dim=64, do_layer_norm_before=True,
                                    activation_function="relu", word_embed_proj_dim=32,
                                    **common), T.OPTForCausalLM),
        "opt_350m": lambda: (T.OPTConfig(hidden_size=48, ffn_dim=96, do_layer_norm_before=False,
                                         activation_function="relu", word_embed_proj_dim=24,
                                         **common), T.OPTForCausalLM),
        "gpt_neox": lambda: (T.GPTNeoXConfig(hidden_size=32, intermediate_size=64,
                                             rotary_pct=0.25, use_parallel_residual=True,
                                             tie_word_embeddings=False, **common),
                             T.GPTNeoXForCausalLM),
    }[family]()
    torch.manual_seed(seed)
    model = cls(cfg).eval()
    with torch.no_grad():   # biases and norms away from 0 and 1, so none hides
        for name, p in model.named_parameters():
            if name.endswith("bias") or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    return model, {**cfg.to_dict(), "model_type": cfg.model_type}


def _state_dict(model) -> dict:
    return {k: v.detach().float().numpy() for k, v in model.state_dict().items()}


def _port_logits(flat, cfg: DecoderConfig, ids) -> np.ndarray:
    dec = load_flat(Decoder(cfg, device="cpu"), flat)
    with torch.inference_mode():
        return dec(torch.as_tensor(ids))[0].numpy()


def _hf_logits(model, ids) -> np.ndarray:
    with torch.no_grad():
        return model(torch.as_tensor(ids)).logits.float().numpy()


FAMILIES = ["qwen2", "llama", "opt", "opt_350m", "gpt_neox"]


@pytest.mark.parametrize("family", FAMILIES)
def test_convert_equals_jax_and_logits_match_hf(family):
    model, hf_dict = _hf_model(family)
    sd = _state_dict(model)
    cfg = DecoderConfig(**config_from_hf_dict(hf_dict), dtype="float32")
    got = hf_convert.convert_state_dict(sd, cfg)
    want = _flatten(jax_hf.convert_state_dict(
        sd, JaxDecoderConfig(**jax_config_from_hf_dict(hf_dict), dtype="float32")))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, size=(2, 12))
    np.testing.assert_allclose(_port_logits(got, cfg, ids), _hf_logits(model, ids), **HF_TOL)


@pytest.mark.parametrize("safe", [True, False], ids=["safetensors", "bin"])
def test_load_hf_state_dict_from_a_directory_and_the_hub_cache(tmp_path, monkeypatch, safe):
    """A local directory (safetensors or pytorch_model.bin), and a hub name
    through a local HF cache's snapshot, read without transformers."""
    model, _ = _hf_model("qwen2")
    model.save_pretrained(tmp_path / "dir", safe_serialization=safe)
    want = {k: v for k, v in _state_dict(model).items() if k != "lm_head.weight"}
    got = hf_convert.load_hf_state_dict(str(tmp_path / "dir"))
    assert set(want) <= set(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    repo = tmp_path / "hf_home" / "hub" / "models--tiny-org--tiny-qwen"
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("abc123")
    model.save_pretrained(repo / "snapshots" / "abc123", safe_serialization=safe)
    monkeypatch.setenv("HF_HOME", str(tmp_path / "hf_home"))
    monkeypatch.delenv("HF_HUB_CACHE", raising=False)
    cached = hf_convert.load_hf_state_dict("tiny-org/tiny-qwen")
    for k in want:
        np.testing.assert_array_equal(cached[k], want[k], err_msg=k)
    with pytest.raises(FileNotFoundError, match="nothing is downloaded"):
        hf_convert.load_hf_state_dict("tiny-org/absent")


@pytest.mark.parametrize("family", ["qwen2", "llama"])
def test_resize_keeps_rows_exactly_and_draws_new_ones_around_the_mean(family):
    model, hf_dict = _hf_model(family)
    cfg = DecoderConfig(**config_from_hf_dict(hf_dict), dtype="float32")
    params = hf_convert.convert_state_dict(_state_dict(model), cfg)
    resized = hf_convert.resize_embeddings(params, cfg, 2000, seed=0)
    assert resized["embed"].shape == (2000, 32)
    np.testing.assert_array_equal(resized["embed"][:99], params["embed"])
    fresh = resized["embed"][99:]
    mean = params["embed"].mean(axis=0)
    std_err = cfg.initializer_range / np.sqrt(len(fresh))
    assert np.all(np.abs(fresh.mean(axis=0) - mean) < 3 * std_err + 1e-7)
    assert abs((fresh - mean).std() / cfg.initializer_range - 1) < 0.1
    if "lm_head" in params:
        assert resized["lm_head"].shape == (32, 2000)
        np.testing.assert_array_equal(resized["lm_head"][:, :99], params["lm_head"])
        assert abs((resized["lm_head"][:, 99:] - mean[:, None]).std()
                   / cfg.initializer_range - 1) < 0.1
    again = hf_convert.resize_embeddings(params, cfg, 2000, seed=0)
    np.testing.assert_array_equal(again["embed"], resized["embed"])
    # a smaller unit vocabulary keeps the first rows, as JAX does
    want = jax_hf.resize_embeddings({k: jnp.asarray(v) for k, v in params.items()},
                                    cfg, 50)
    np.testing.assert_array_equal(hf_convert.resize_embeddings(params, cfg, 50)["embed"],
                                  np.asarray(want["embed"]))


@pytest.mark.parametrize("family", ["qwen2", "llama", "opt", "opt_350m"])
def test_export_round_trips_and_equals_jax(family, tmp_path):
    """export_hf_checkpoint: its state dict equals the JAX package's export
    of the same parameters; transformers loads it with the same logits; the
    port reads it back to the same parameters."""
    model, hf_dict = _hf_model(family)
    cfg = DecoderConfig(**config_from_hf_dict(hf_dict), dtype="float32")
    params = hf_convert.convert_state_dict(_state_dict(model), cfg)
    jcfg = JaxDecoderConfig(**jax_config_from_hf_dict(hf_dict), dtype="float32")
    jax_params = jax_hf.convert_state_dict(_state_dict(model), jcfg)
    want = jax_hf.export_hf_state_dict(jax_params, jcfg)
    got = hf_convert.export_hf_state_dict(params, cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    out = tmp_path / "export"
    hf_convert.export_hf_checkpoint(params, cfg, "tiny", str(out))
    back = transformers.AutoModelForCausalLM.from_pretrained(
        str(out), attn_implementation="eager").eval()
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, size=(2, 12))
    np.testing.assert_allclose(_hf_logits(back, ids), _port_logits(params, cfg, ids), **HF_TOL)
    again = hf_convert.convert_state_dict(hf_convert.load_hf_state_dict(str(out)), cfg)
    for k in params:
        np.testing.assert_array_equal(again[k], params[k], err_msg=k)


def test_unit_lm_export_hf_loads_in_transformers(tmp_path):
    lm = UnitLM(UnitLMConfig(base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502,
                             twist_init=False, torch_dtype="float32", rope_theta=10000,
                             config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                                   num_attention_heads=4,
                                                   num_key_value_heads=2, head_dim=16,
                                                   intermediate_size=128)),
                seed=0, device="cpu")
    lm.export_hf(str(tmp_path / "hf"))
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        str(tmp_path / "hf"), attn_implementation="eager").eval()
    ids = np.random.RandomState(2).randint(0, 502, size=(2, 20))
    with torch.inference_mode():
        want = lm.decoder(torch.as_tensor(ids))[0].numpy()
    np.testing.assert_allclose(_hf_logits(hf, ids), want, **HF_TOL)


def _reference_dir(tmp_path):
    """A checkpoint as the reference toolkit saves one: the wrapped causal
    LM's weights under 'lm.' (tied head dropped), model_type
    speech_language_model, the base's own config nested."""
    from slamkit_tpu_torch.utils.safetensors import write_safetensors

    model, hf_dict = _hf_model("qwen2", vocab=502)
    d = tmp_path / "ref_ckpt"
    d.mkdir()
    write_safetensors(str(d / "model.safetensors"),
                      {f"lm.{k}": v for k, v in _state_dict(model).items()
                       if k != "lm_head.weight"})
    (d / "config.json").write_text(json.dumps({
        "model_type": "speech_language_model", "base_model_name": "Qwen/Qwen2.5-0.5B",
        "base_config": hf_dict, "vocab_size": 502, "twist_init": True,
        "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 1}))
    return d, model


def test_reference_checkpoint_gives_the_jax_logits(tmp_path):
    d, model = _reference_dir(tmp_path)
    port = UnitLM.from_pretrained(str(d), device="cpu", torch_dtype="float32")
    ref = JaxUnitLM.from_pretrained(str(d), torch_dtype="float32")
    assert port.config.to_dict() == ref.config.to_dict()
    assert dataclasses.asdict(port.decoder.cfg) == {
        **dataclasses.asdict(ref.decoder), "attn_impl": port.decoder.cfg.attn_impl}
    ids = np.random.RandomState(0).randint(0, 502, size=(2, 10))
    with torch.inference_mode():
        got = port.decoder(torch.as_tensor(ids))[0].numpy()
    want, _ = jax_forward(ref.params, dataclasses.replace(ref.decoder, attn_impl="xla"),
                          jnp.asarray(ids, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got, _hf_logits(model, ids), **HF_TOL)
    with_remat = UnitLM.from_pretrained(str(d), device="cpu", torch_dtype="float32",
                                        remat=True)
    assert with_remat.decoder.cfg.remat


def test_twist_init_loads_local_base_weights_like_jax(tmp_path):
    """twist_init with the base LM on disk: the port's UnitLM starts from the
    same parameters as the JAX package's (a base vocabulary of 600 cut to 502
    units keeps every row, so no fresh row is drawn)."""
    model, _ = _hf_model("qwen2", vocab=600)
    model.save_pretrained(tmp_path / "base")
    cfg = dict(base_model_name=str(tmp_path / "base"), vocab_size=502, twist_init=True,
               torch_dtype="float32")
    port = UnitLM(UnitLMConfig(**cfg), seed=0, device="cpu")
    ref = JaxUnitLM(JaxUnitLMConfig(**cfg), seed=0)
    want = _flatten(ref.params)
    got = to_flat(port.decoder)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_twist_weights_that_do_not_convert_raise(tmp_path, monkeypatch):
    """Weights that are found but do not fit the base's architecture (a
    2-layer qwen2 where the 6-layer pythia-14m is named) raise; only
    unreachable weights fall back to random init."""
    model, _ = _hf_model("qwen2")
    repo = tmp_path / "hub" / "models--EleutherAI--pythia-14m" / "snapshots" / "r1"
    model.save_pretrained(repo)
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    with pytest.raises(KeyError, match="model.layers.2"):
        UnitLM(UnitLMConfig(base_model_name="EleutherAI/pythia-14m", vocab_size=502,
                            twist_init=True, torch_dtype="float32"), device="cpu")


@pytest.mark.parametrize("case", ["unreachable", "reheaded"])
def test_twist_init_without_usable_weights_warns_and_inits_randomly(
        tmp_path, monkeypatch, caplog, case):
    """The base's weights are not on this machine, or the overrides re-head
    it (slam_dh128's 14 x 64 -> 7 x 128): a warning, then the same random
    init as twist_init=False from the same seed."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    cfg = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=502,
               torch_dtype="float32")
    if case == "reheaded":
        cfg["config_overrides"] = {"num_attention_heads": 2, "head_dim": 64}
    with caplog.at_level(logging.WARNING, logger="slamkit_tpu_torch.models.hf_convert"):
        lm = UnitLM(UnitLMConfig(**cfg, twist_init=True), seed=4, device="cpu")
    words = "unavailable" if case == "unreachable" else "reinterpreted"
    assert any(words in r.getMessage() for r in caplog.records), caplog.text
    fresh = UnitLM(UnitLMConfig(**cfg, twist_init=False), seed=4, device="cpu")
    for a, b in zip(lm.decoder.parameters(), fresh.decoder.parameters()):
        assert torch.equal(a, b)


def test_tlm_factory_forwards_remat_to_pretrained(tmp_path):
    """training_args.remat (wired into config_args by cli/train) reaches the
    model on the pretrained_model path too, as in the JAX package: the same
    decoder config with remat on."""
    from slamkit_tpu.models.unit_lm import tlm_factory as jax_tlm_factory

    cfg = JaxUnitLMConfig(base_model_name="EleutherAI/pythia-14m", vocab_size=64,
                          twist_init=False)
    JaxUnitLM(cfg, seed=0).save_pretrained(str(tmp_path / "ckpt"))
    node = {"tlm_type": "twist", "pretrained_model": str(tmp_path / "ckpt"),
            "config_args": {"remat": True, "remat_layers": 3}}
    port = tlm_factory(ConfigNode(node), device="cpu")
    ref = jax_tlm_factory(ConfigNode(node))
    assert port.config.remat is True and port.decoder.cfg.remat
    assert port.config.to_dict() == ref.config.to_dict()
    assert dataclasses.asdict(port.decoder.cfg) == dataclasses.asdict(ref.decoder)
