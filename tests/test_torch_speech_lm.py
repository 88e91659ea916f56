"""Speech continuation end to end, the port against the JAX package, on the CPU.

Seeded WAV prompts in a temporary directory go through each package's
`generative_metric.generate` and a `SpeechLM` of the same weights: the
fixture HuBERT (tests/fixtures/hubert_parity.npz, tap 3) with a seeded
20-unit k-means, a tiny Qwen2-layout UnitLM saved by the JAX package and
loaded by the port, and a tiny CodeHiFiGAN with a duration predictor. Greedy
decoding, dense and `weight_quant="int8"` (on the CPU the port's dq_matmul
runs its plain version and counts no launch).

Tolerances: the prompts and the unit sequences handed to the vocoder
exactly (the same WAV samples, argmins and greedy argmaxes, away from ties
at these seeds); the waveforms rtol 1e-4, atol 1e-5, as the vocoder's own
parity test (float32 convolutions summed in another order); log likelihoods
1e-4 (float32 decoders, as the UnitLM scoring tests).
"""
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.feature_extractor import hubert_jax
from slamkit_tpu.feature_extractor.hubert_feature_extractor import \
    HubertFeatureExtractor as JaxHubertFE
from slamkit_tpu.metric import generative_metric as jax_metric
from slamkit_tpu.models.speech_lm import SpeechLM as JaxSpeechLM
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu.vocoder import hifigan_jax
from slamkit_tpu.vocoder.hifi_gan_vocoder import HiFiGANVocoder as JaxVocoder
from slamkit_tpu_torch.feature_extractor import HubertConfig, HubertFeatureExtractor
from slamkit_tpu_torch.feature_extractor.hubert import convert_hf_state_dict
from slamkit_tpu_torch.metric import generative_metric
from slamkit_tpu_torch.models import SpeechLM, UnitLM
from slamkit_tpu_torch.ops import dq_matmul, flash_attention_fwd
from slamkit_tpu_torch.tokeniser import UnitTokeniser
from slamkit_tpu_torch.utils.audio import save_wav
from slamkit_tpu_torch.vocoder import HiFiGANVocoder
from slamkit_tpu_torch.vocoder.hifigan import convert_torch_generator, random_state_dict

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "hubert_parity.npz"
N_UNITS, LAYER = 20, 3
SMALL_QWEN = dict(
    base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=N_UNITS + 2, twist_init=False,
    torch_dtype="float32", rope_theta=10000,
    config_overrides=dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                          num_key_value_heads=2, head_dim=16, intermediate_size=128))
VOC_CFG = {
    "model_in_dim": 8, "upsample_initial_channel": 16, "upsample_rates": [4, 2],
    "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]], "num_embeddings": N_UNITS,
    "embedding_dim": 8,
    "dur_predictor_params": {"encoder_embed_dim": 8, "var_pred_hidden_dim": 16,
                             "var_pred_kernel_size": 3, "var_pred_dropout": 0.0},
}
GEN = dict(max_new_tokens=6, do_sample=False, seed=0)


class Recorder:
    """Wraps a vocoder and keeps the unit sequences it was asked to vocode."""

    def __init__(self, vocoder):
        self.vocoder, self.calls = vocoder, []

    def vocode_batch(self, codes):
        self.calls.append([np.asarray(c).copy() for c in codes])
        return self.vocoder.vocode_batch(codes)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    f = np.load(FIXTURE)
    cfg_dict = json.loads(bytes(f["config_json"]).decode())
    sd = {k[len("sd::"):]: f[k] for k in f.files if k.startswith("sd::")}
    rng = np.random.default_rng(11)
    centroids = rng.standard_normal((N_UNITS, cfg_dict["hidden_size"])).astype(np.float32)
    voc_sd = random_state_dict(VOC_CFG, seed=2)
    voc_sd["dur_predictor.proj.bias"] = np.array([1.2], np.float32)
    ckpt = tmp_path_factory.mktemp("speech_lm_ckpt")
    JaxUnitLM(JaxUnitLMConfig(**SMALL_QWEN), seed=3).save_pretrained(str(ckpt))
    wavs = tmp_path_factory.mktemp("prompts")
    for i, seconds in enumerate((0.7, 0.45, 0.62)):
        t = np.arange(int(seconds * 16000)) / 16000
        tone = 0.3 * np.sin(2 * np.pi * (180 + 60 * i) * t)
        save_wav(str(wavs / f"p{i}.wav"), tone + 0.05 * rng.standard_normal(t.size))
    return dict(cfg_dict=cfg_dict, sd=sd, centroids=centroids, voc_sd=voc_sd,
                ckpt=str(ckpt), glob=str(wavs / "*.wav"))


def _port(p):
    cfg = HubertConfig.from_hf_dict(p["cfg_dict"])
    fe = HubertFeatureExtractor.from_params(convert_hf_state_dict(p["sd"], cfg), cfg,
                                            p["centroids"], layer=LAYER, device="cpu")
    voc = HiFiGANVocoder.from_params(convert_torch_generator(p["voc_sd"], VOC_CFG), VOC_CFG,
                                     device="cpu")
    return SpeechLM(UnitLM.from_pretrained(p["ckpt"], device="cpu"), UnitTokeniser(fe, num_units=N_UNITS),
                    Recorder(voc))


def _jax(p):
    jcfg = hubert_jax.HubertConfig.from_hf_dict(p["cfg_dict"])
    fe = JaxHubertFE.__new__(JaxHubertFE)
    fe.layer, fe.num_units, fe.bucket_samples, fe.config = LAYER, N_UNITS, None, jcfg
    fe.params = jax.tree_util.tree_map(jnp.asarray,
                                       hubert_jax.convert_hf_state_dict(p["sd"], jcfg))
    fe.centroids = jnp.asarray(p["centroids"])
    fe._extract_jit = jax.jit(fe._extract_fn)
    voc = JaxVocoder.__new__(JaxVocoder)
    voc.params = hifigan_jax.convert_torch_generator(p["voc_sd"], VOC_CFG)
    voc.cfg, voc.speakers, voc.styles = VOC_CFG, None, None
    voc.has_dur_predictor, voc.bucket_frames = True, None
    return JaxSpeechLM(JaxUnitLM.from_pretrained(p["ckpt"]),
                       JaxUnitTokeniser(fe, num_units=N_UNITS), vocoder=Recorder(voc))


@pytest.mark.parametrize("weight_quant", [None, "int8"])
def test_speech_continuation_matches_jax(parts, weight_quant):
    port, ref = _port(parts), _jax(parts)
    kw = dict(batch_size=2, prompt_length=0.5, num_workers=2, weight_quant=weight_quant, **GEN)
    before = (dq_matmul.launches, flash_attention_fwd.launches)
    got = generative_metric.generate(port, parts["glob"], **kw)
    want = jax_metric.generate(ref, parts["glob"], **kw)
    assert (dq_matmul.launches, flash_attention_fwd.launches) == before
    assert len(got["prompts"]) == len(want["prompts"]) == 3
    for g, w in zip(got["prompts"], want["prompts"]):
        np.testing.assert_array_equal(g, w)
    units_got = [c for call in port.vocoder.calls for c in call]
    units_want = [c for call in ref.vocoder.calls for c in call]
    assert len(units_got) == len(units_want) == 3
    for g, w in zip(units_got, units_want):
        np.testing.assert_array_equal(g, w)
        assert g.size > GEN["max_new_tokens"]      # prompt units + continuation
    for g, w in zip(got["generate"], want["generate"]):
        assert g.dtype == np.float32 and g.shape == w.shape and g.size > 0
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_speech_lm_scores_and_remove_prompt_match_jax(parts):
    port, ref = _port(parts), _jax(parts)
    port.vocoder = ref.vocoder = None
    rng = np.random.default_rng(0)
    wavs = (0.1 * rng.standard_normal((2, 9000))).astype(np.float32)
    lens = np.array([9000, 6000])
    np.testing.assert_allclose(port.log_likelihood(wavs, lens).numpy(),
                               np.asarray(ref.log_likelihood(wavs, lens)), atol=1e-4, rtol=0)
    full = port.generate(wavs, lens, **GEN)
    cont = port.generate(wavs, lens, remove_prompt=True, **GEN)
    want = ref.generate(wavs, lens, remove_prompt=True, **GEN)
    for f, c, w in zip(full, cont, want):
        np.testing.assert_array_equal(c, w)
        assert len(c) < len(f)


def test_speech_lm_refuses_components_on_other_devices(parts):
    port = _port(parts)
    port.tokeniser.model.device = torch.device("meta")
    with pytest.raises(ValueError, match="one device"):
        SpeechLM(port.model, port.tokeniser)
