"""The port's entry points run on the CUDA card by default. On a host without
one, a call that leaves the device at its default raises an error that names
the card and says how to ask for the CPU; it never carries on on the CPU. The
same call with device="cpu" runs."""
import numpy as np
import pytest
import torch

from slamkit_tpu.config.node import ConfigNode
from slamkit_tpu_torch.feature_extractor import HubertConfig, HubertFeatureExtractor
from slamkit_tpu_torch.feature_extractor import hubert
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, tlm_factory
from slamkit_tpu_torch.tokeniser import tokeniser_factory
from slamkit_tpu_torch.utils.device import resolve_device
from slamkit_tpu_torch.vocoder import HiFiGANVocoder, hifigan, vocoder_factory

torch.set_num_threads(1)

TINY_LM = dict(base_model_name="Qwen/Qwen2.5-0.5B", vocab_size=502, twist_init=False,
               torch_dtype="float32",
               config_overrides=dict(num_hidden_layers=1, hidden_size=32, num_attention_heads=2,
                                     num_key_value_heads=1, head_dim=16, intermediate_size=64))
TINY_HUBERT = HubertConfig(conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                           hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=32, num_conv_pos_embeddings=4,
                           num_conv_pos_embedding_groups=2)
TINY_VOC = {"model_in_dim": 8, "num_embeddings": 500, "embedding_dim": 8,
            "upsample_initial_channel": 8, "upsample_rates": [2], "upsample_kernel_sizes": [4],
            "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]],
            "dur_predictor_params": {"encoder_embed_dim": 8, "var_pred_hidden_dim": 8,
                                     "var_pred_kernel_size": 3}}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a CUDA card")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A UnitLM checkpoint and a CodeHiFiGAN checkpoint with its config."""
    import json

    root = tmp_path_factory.mktemp("entry_points")
    UnitLM(UnitLMConfig(**TINY_LM), device="cpu").save_pretrained(str(root / "lm"))
    sd = hifigan.random_state_dict(TINY_VOC, seed=0)
    torch.save({"generator": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}},
               root / "g.pt")
    (root / "config.json").write_text(json.dumps(TINY_VOC))
    return root


def _hubert_params():
    return hubert.random_params(TINY_HUBERT)


ENTRY_POINTS = {
    "UnitLM": lambda f: UnitLM(UnitLMConfig(**TINY_LM)),
    "UnitLM.from_pretrained": lambda f: UnitLM.from_pretrained(str(f / "lm")),
    "tlm_factory": lambda f: tlm_factory(ConfigNode({
        "tlm_type": "gslm", "pretrained_model": None,
        "config_args": {**{k: v for k, v in TINY_LM.items() if k != "config_overrides"},
                        **TINY_LM["config_overrides"]}})),
    "HubertFeatureExtractor.from_params": lambda f: HubertFeatureExtractor.from_params(
        _hubert_params(), TINY_HUBERT, np.zeros((500, 16), np.float32), layer=1),
    "HubertFeatureExtractor": lambda f: HubertFeatureExtractor(
        pretrained_model="slprl/mhubert-base-25hz", load_config_only=True),
    "load_hubert": lambda f: hubert.load_hubert(str(f / "no_hubert_here")),
    "HiFiGANVocoder.from_params": lambda f: HiFiGANVocoder.from_params(
        hifigan.convert_torch_generator(hifigan.random_state_dict(TINY_VOC), TINY_VOC),
        TINY_VOC),
    "HiFiGANVocoder": lambda f: HiFiGANVocoder(model_path=str(f / "g.pt"),
                                               config_path=str(f / "config.json")),
    "load_checkpoint": lambda f: hifigan.load_checkpoint(str(f / "g.pt"),
                                                         str(f / "config.json")),
    "vocoder_factory": lambda f: vocoder_factory(
        {"vocoder_type": "hifigan", "model_path": str(f / "g.pt"),
         "config_path": str(f / "config.json")}),
    "tokeniser_factory": lambda f: tokeniser_factory(
        {"tokeniser_type": "unit", "feature_extractor_type": "hubert",
         "feature_extractor": {"pretrained_model": "slprl/mhubert-base-25hz",
                               "load_config_only": True, "num_units": 500}}),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_needs_the_card(no_card, files, name):
    with pytest.raises(RuntimeError, match=r"no CUDA card.*device=\"cpu\""):
        ENTRY_POINTS[name](files)


def test_resolve_device(no_card):
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        resolve_device("cuda:0")


def test_explicit_cpu_runs(files):
    lm = UnitLM.from_pretrained(str(files / "lm"), device="cpu")
    assert lm.device == torch.device("cpu")
    assert torch.isfinite(lm.log_likelihood([[1, 5, 6, 7, 1]])).all()
    voc = vocoder_factory({"vocoder_type": "hifigan", "model_path": str(files / "g.pt"),
                           "config_path": str(files / "config.json")}, device="cpu")
    assert voc.params["dict"].device == torch.device("cpu")
    fe = HubertFeatureExtractor.from_params(_hubert_params(), TINY_HUBERT,
                                            np.zeros((500, 16), np.float32), layer=1,
                                            device="cpu")
    assert fe.device == torch.device("cpu")
