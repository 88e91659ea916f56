"""The port's Whisper (`metric/whisper.py`, `metric/whisper_features.py`)
against the JAX package's (`slamkit_tpu/metric/whisper_jax.py`) and against
what the JAX pipeline takes from transformers, on the CPU.

The checkpoint is `tools/genppl_recipe.write_whisper_dir(tiny=True)`:
whisper-large-v3-turbo's vocabulary, ids, generation config and 128 mel
bins at 32 wide and 2 + 2 layers, seeded random F16 weights; the weight
conversion is also held on a state dict of transformers'
`WhisperForConditionalGeneration`.

Tolerances: log-mel features 1e-5 absolute (the same float32 torch.stft on
both sides; the filter bank is the same float64 formula); conversion bit for
bit; encoder outputs and decoder logits 1e-5 absolute and relative (float32
on both sides, XLA's and torch's summation orders); greedy tokens, masks,
forced prefixes and texts exactly.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.metric import whisper_jax
from slamkit_tpu_torch.metric import whisper as port_whisper
from slamkit_tpu_torch.metric.generative_metric import _transcribe
from slamkit_tpu_torch.metric.whisper_features import WhisperFeatures
from slamkit_tpu_torch.tokeniser.text_tokeniser import TextTokeniser
from slamkit_tpu_torch.tools import genppl_recipe

transformers = pytest.importorskip("transformers")

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    return genppl_recipe.write_whisper_dir(tmp_path_factory.mktemp("whisper"), tiny=True)


@pytest.fixture(scope="module")
def both(ckpt):
    """(port model, JAX params, cfg, numpy state dict)."""
    with open(f"{ckpt}/config.json") as f:
        cfg = port_whisper.WhisperCfg.from_hf_dict(json.load(f))
    sd = port_whisper.load_whisper_state_dict(ckpt)
    jcfg = whisper_jax.WhisperCfg.from_hf(transformers.WhisperConfig.from_pretrained(ckpt))
    assert dataclasses_equal(cfg, jcfg)
    params = port_whisper.convert_whisper_state_dict(sd, cfg)
    model = port_whisper.Whisper(params, cfg, device="cpu")
    jparams = whisper_jax.convert_whisper_state_dict(sd, jcfg)
    return model, jparams, jcfg, sd


def dataclasses_equal(a, b) -> bool:
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


def _mel(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.num_mel_bins, 2 * cfg.max_source_positions)
                               ).astype(np.float32)


# --------------------------------------------------------------------------- #
# front end
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("feature_size", [8, 80, 128])
def test_log_mel_matches_whisper_feature_extractor(feature_size):
    """Clips of 0.3 s, exactly one 30 s window and 31 s (cut to the window)."""
    rng = np.random.default_rng(feature_size)
    clips = [(0.1 * rng.standard_normal(n)).astype(np.float32)
             for n in (4800, 480000, 496000)]
    clips[0] += np.sin(np.arange(4800) / 5.0).astype(np.float32)
    ref = transformers.WhisperFeatureExtractor(feature_size=feature_size)
    want = ref(clips, sampling_rate=16000, return_tensors="np").input_features
    got = WhisperFeatures(feature_size=feature_size, device="cpu")(clips).numpy()
    assert got.shape == want.shape == (3, feature_size, 3000)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_features_read_the_preprocessor_config(ckpt):
    fe = WhisperFeatures.from_pretrained(ckpt, device="cpu")
    assert (fe.feature_size, fe.n_samples, fe.hop_length, fe.n_fft) == (128, 480000, 160, 400)
    with pytest.raises(NotImplementedError, match="dither"):
        WhisperFeatures(dither=1e-5)


# --------------------------------------------------------------------------- #
# weights, encoder, decoder
# --------------------------------------------------------------------------- #
def test_convert_state_dict_is_bitwise_the_jax_conversion():
    hf_cfg = transformers.WhisperConfig(
        vocab_size=96, num_mel_bins=8, d_model=16, encoder_layers=2,
        encoder_attention_heads=2, decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=32, decoder_ffn_dim=32, max_source_positions=24,
        max_target_positions=16, decoder_start_token_id=1, eos_token_id=2, pad_token_id=3)
    torch.manual_seed(0)
    model = transformers.WhisperForConditionalGeneration(hf_cfg).eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    port_cfg = port_whisper.WhisperCfg.from_hf_dict(hf_cfg.to_dict())
    jcfg = whisper_jax.WhisperCfg.from_hf(hf_cfg)
    assert dataclasses_equal(port_cfg, jcfg)
    got = port_whisper.convert_whisper_state_dict(sd, port_cfg)
    want = whisper_jax.convert_whisper_state_dict(sd, jcfg)

    def walk(a, b, path=""):
        assert type(a) is type(b) and (not isinstance(a, dict) or a.keys() == b.keys()), path
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif a is None:
            assert b is None, path
        else:
            assert a.dtype == b.dtype == np.float32, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    walk(got, want)


def test_config_defaults_are_whisper_configs():
    """Keys absent from config.json take transformers' WhisperConfig defaults."""
    want = whisper_jax.WhisperCfg.from_hf(transformers.WhisperConfig(d_model=64))
    got = port_whisper.WhisperCfg.from_hf_dict({"d_model": 64})
    assert dataclasses_equal(got, want)


def test_encoder_matches_jax(both):
    model, jparams, jcfg, _ = both
    mel = _mel(jcfg)
    want = np.asarray(whisper_jax.encode(jparams, jcfg, jnp.asarray(mel)))
    got = model.encode(torch.from_numpy(mel)).numpy()
    assert got.shape == want.shape == (2, 1500, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_decoder_stepwise_logits_match_jax(both):
    model, jparams, jcfg, _ = both
    mel = _mel(jcfg, seed=1)
    ids = np.array([[50258, 50259, 50360, 50364, 9, 33, 12000, 5],
                    [50258, 50259, 50360, 50364, 50, 8, 20, 41000]], np.int32)
    enc = whisper_jax.encode(jparams, jcfg, jnp.asarray(mel))
    xk, xv = whisper_jax._cross_kv(jparams, jcfg, enc)
    t_max, hd = ids.shape[1], jcfg.d_model // jcfg.decoder_heads
    shape = (jcfg.decoder_layers, 2, jcfg.decoder_heads, t_max, hd)
    cache = {"k": jnp.zeros(shape, jnp.float32), "v": jnp.zeros(shape, jnp.float32)}
    enc_t = model.encode(torch.from_numpy(mel))
    xkv, port_cache = model.cross_kv(enc_t), model.new_cache(2, t_max)
    for i in range(t_max):
        want, cache = whisper_jax._decoder_step(jparams, jcfg, jnp.asarray(ids[:, i]),
                                                jnp.int32(i), cache, xk, xv)
        got = model.decoder_step(torch.from_numpy(ids[:, i]).long(), i, port_cache, xkv)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"step {i}", **TOL)


def _plans(ckpt):
    with open(f"{ckpt}/config.json") as f:
        hf = json.load(f)
    with open(f"{ckpt}/generation_config.json") as f:
        gen = json.load(f)
    return hf, gen


def test_decode_plan_matches_jax(ckpt, both):
    """The forced prefix and the suppress / begin-suppress masks, from
    generation_config.json, and from config.json alone (the defaults)."""
    _, _, jcfg, _ = both
    hf, gen = _plans(ckpt)
    cfg = port_whisper.WhisperCfg.from_hf_dict(hf)
    hf_cfg = transformers.WhisperConfig.from_pretrained(ckpt)
    for port_gen, jax_gen in ((gen, transformers.GenerationConfig.from_pretrained(ckpt)),
                              (None, None)):
        forced, sup, begin = port_whisper.decode_plan(hf, port_gen, cfg)
        jforced, jsup, jbegin = whisper_jax._decode_plan(hf_cfg, jax_gen, jcfg)
        assert forced == jforced
        for a, b in ((sup, jsup), (begin, jbegin)):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, np.asarray(b))
    assert forced == [50258] and sup is None and np.flatnonzero(begin).tolist() == [220, 50257]
    forced, sup, begin = port_whisper.decode_plan(hf, gen, cfg)
    assert forced == [50258, 50259, 50360, 50364]
    assert np.flatnonzero(sup).tolist() == genppl_recipe.WHISPER_SUPPRESS


def test_decode_plan_null_slot_raises_as_jax_does(ckpt, both):
    """HF's `[1, null]` language slot: both packages raise (the port names it)."""
    _, _, jcfg, _ = both
    hf, gen = _plans(ckpt)
    gen = dict(gen, forced_decoder_ids=[[1, None], [2, 50360]])
    with pytest.raises(ValueError, match="slot 1 has no token"):
        port_whisper.decode_plan(hf, gen, port_whisper.WhisperCfg.from_hf_dict(hf))

    class Gen:
        forced_decoder_ids = gen["forced_decoder_ids"]
        suppress_tokens = begin_suppress_tokens = None

    with pytest.raises(TypeError):
        whisper_jax._decode_plan(transformers.WhisperConfig.from_pretrained(ckpt), Gen(), jcfg)


def test_greedy_tokens_equal_jax(ckpt, both):
    model, jparams, jcfg, _ = both
    hf, gen = _plans(ckpt)
    forced, sup, begin = port_whisper.decode_plan(hf, gen, model.cfg)
    mel = _mel(jcfg, b=3, seed=2)
    enc = whisper_jax.encode(jparams, jcfg, jnp.asarray(mel))
    want = np.asarray(whisper_jax.greedy_decode(
        jparams, jcfg, enc, jnp.asarray(forced, jnp.int32), max_new_tokens=40,
        n_forced=len(forced), suppress_mask=jnp.asarray(sup),
        begin_suppress_mask=jnp.asarray(begin)))
    got = model.greedy_decode(model.encode(torch.from_numpy(mel)), forced, 40,
                              torch.from_numpy(sup), torch.from_numpy(begin)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:, :4] == forced).all() and not np.isin(got[:, 4:], np.flatnonzero(sup)).any()
    assert not np.isin(got[:, 4], [220, 50257]).any()


def test_greedy_decode_stops_early_with_the_same_tokens(both):
    """Once every row has emitted eos the loop may stop: the tokens are those
    of the full loop (eos to the end)."""
    model, _, jcfg, _ = both
    enc = model.encode(torch.from_numpy(_mel(jcfg, b=2, seed=3)))
    eos = model.cfg.eos_token_id
    full = model.greedy_decode(enc, [50258], 40)
    favour = torch.zeros(model.cfg.vocab_size, dtype=torch.bool)
    favour[[i for i in range(model.cfg.vocab_size) if i != eos]] = True
    # every id but eos suppressed: eos at once, then eos padding
    stopped = model.greedy_decode(enc, [50258], 40, suppress_mask=favour)
    assert (stopped[:, 1:] == eos).all() and stopped.shape == full.shape


# --------------------------------------------------------------------------- #
# text
# --------------------------------------------------------------------------- #
def _rows(rng):
    """Rows of ids: timestamps, `<|startofprev|>` prompts, language and task
    tokens, random BPE ids (bytes split across tokens), special tokens."""
    sot, prev, eos = 50258, 50362, 50257
    rows = [
        [sot, 50259, 50360, 50364, 300, 5000, 12000, eos],
        [sot, 50259, 50360, 50365, 300, 5000, 50400, 12000, 51865, eos],
        [prev, 700, 800, sot, 50259, 50360, 50364, 900, 1000],
        [prev, 700, 800, 900],
        [50259, 50359, 50363, 50361, 5, 6],
        [],
        [sot, 220, 220, 30, 31, 32],
    ]
    for _ in range(40):
        row = list(rng.integers(0, 50257, rng.integers(1, 30)))
        if rng.random() < 0.5:
            row.insert(int(rng.integers(0, len(row) + 1)), int(rng.integers(50365, 51866)))
        if rng.random() < 0.3:
            row = [sot, int(rng.integers(50259, 50359)), 50360] + row
        if rng.random() < 0.2:
            row = [prev] + list(rng.integers(0, 50257, 3)) + row
        rows.append([int(i) for i in row])
    return rows


def test_whisper_decode_matches_the_tokenizer(ckpt):
    ref = transformers.AutoProcessor.from_pretrained(ckpt).tokenizer
    port = TextTokeniser.from_pretrained(ckpt)
    for row in _rows(np.random.default_rng(0)):
        for skip in (True, False):
            assert port_whisper.whisper_decode(port, row, skip_special_tokens=skip) == \
                ref.decode(row, skip_special_tokens=skip), (row, skip)
    assert port_whisper.whisper_decode(port, [50258, 50259, 50360, 50365, 300, 51865]) == \
        port.decode([300], skip_special_tokens=True)


# --------------------------------------------------------------------------- #
# pipeline
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def pipes(ckpt):
    from slamkit_tpu.metric.metric_utils import get_whisper_pipeline as jax_get
    from slamkit_tpu_torch.metric.metric_utils import get_whisper_pipeline

    return get_whisper_pipeline(ckpt, device="cpu"), jax_get(ckpt, backend="jax")


def test_pipeline_texts_equal_jax_with_long_form_windows(pipes):
    port, ref = pipes
    n = port.features.n_samples
    rng = np.random.default_rng(5)
    wavs = [(0.1 * rng.standard_normal(int(2.2 * n))).astype(np.float32),
            np.zeros(0, np.float32),
            (0.2 * np.sin(np.arange(12000) / 4.0)).astype(np.float32)]
    got = _transcribe(port, wavs, batch_size=2)
    from slamkit_tpu.metric.generative_metric import _transcribe as jax_transcribe

    want = jax_transcribe(ref, wavs, batch_size=2)
    assert got == want and got[1] == "" and all(len(t) > 0 for t in (got[0], got[2]))
    per_window = port([wavs[0][:n], wavs[0][n:2 * n], wavs[0][2 * n:]], batch_size=4)
    assert got[0] == "".join(w["text"] for w in per_window)


def test_pipeline_rejects_unsupported_kwargs(pipes):
    port, _ = pipes
    with pytest.raises(ValueError, match="unsupported kwargs"):
        port([np.zeros(160, np.float32)], chunk_length_s=30)


def test_pipeline_reads_weights_locally_only(tmp_path):
    with pytest.raises(FileNotFoundError, match="config.json"):
        port_whisper.WhisperPipeline(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="asr dtype"):
        port_whisper.WhisperPipeline(str(tmp_path), dtype="float16", device="cpu")


def test_bfloat16_whisper_tracks_float32(both):
    """asr_dtype=bfloat16 computes in bf16 (layer norms, softmax and logits
    in float32): the encoder within bf16's ~3 significant digits of the
    float32 one over 2 layers, logits float32."""
    import dataclasses

    model, _, jcfg, sd = both
    cfg16 = dataclasses.replace(model.cfg, dtype="bfloat16")
    m16 = port_whisper.Whisper(port_whisper.convert_whisper_state_dict(sd, cfg16), cfg16,
                               device="cpu")
    mel = torch.from_numpy(_mel(jcfg, b=1, seed=4))
    e32, e16 = model.encode(mel), m16.encode(mel)
    assert e16.dtype == torch.bfloat16
    assert float((e16.float() - e32).norm() / e32.norm()) < 2e-2
    logits = m16.decoder_step(torch.tensor([50258]), 0, m16.new_cache(1, 4), m16.cross_kv(e16))
    assert logits.dtype == torch.float32 and logits.shape == (1, 51866)
