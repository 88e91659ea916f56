"""The port's HuBERT encoder, k-means and feature extractor against the JAX
package's, on the CPU in float32.

Tolerances: activations against the recorded fixture as the JAX package's own
test holds them (atol 2e-4, rtol 1e-3: the recording is a torch HF forward);
against `hubert_jax.forward` 1e-4 absolute and relative (both are float32
convolutions and matmuls, summed in another order). Unit ids exactly: the
argmin of the same float32 distances, away from ties at these seeded inputs.
"""
import json
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.feature_extractor import hubert_jax
from slamkit_tpu.feature_extractor.hubert_feature_extractor import \
    HubertFeatureExtractor as JaxHubertFE
from slamkit_tpu.feature_extractor.kmeans import assign_clusters as jax_assign
from slamkit_tpu_torch.feature_extractor import (HUBERT_CONFIG_PRESETS, HubertConfig,
                                                 HubertFeatureExtractor, assign_clusters,
                                                 load_kmeans_centroids)
from slamkit_tpu_torch.feature_extractor import hubert
from slamkit_tpu_torch.utils.tree import to_torch

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

FIXTURE = pathlib.Path(__file__).parent / "fixtures" / "hubert_parity.npz"
N_UNITS = 20


@pytest.fixture(scope="module")
def fixture():
    f = np.load(FIXTURE)
    cfg_dict = json.loads(bytes(f["config_json"]).decode())
    sd = {k[len("sd::"):]: f[k] for k in f.files if k.startswith("sd::")}
    return f, cfg_dict, sd


def _tiny_postnorm_cfg(mod):
    """hubert-base's layout (group norm on conv 0, post-norm blocks) at a
    tiny width."""
    return mod.HubertConfig(conv_dim=(16,) * 4, conv_kernel=(10, 3, 3, 2),
                            conv_stride=(5, 2, 2, 2), hidden_size=32, num_hidden_layers=3,
                            num_attention_heads=4, intermediate_size=64,
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


@pytest.mark.parametrize("layer", [2, 3])
def test_stable_norm_taps_match_fixture_and_jax(fixture, layer):
    f, cfg_dict, sd = fixture
    cfg = HubertConfig.from_hf_dict(cfg_dict)
    params = hubert.convert_hf_state_dict(sd, cfg)
    got = hubert.forward(to_torch(params), cfg, torch.from_numpy(f["wav"])[None],
                         tap_layer=layer).numpy()
    np.testing.assert_allclose(got, f[f"hidden_{layer}"], atol=2e-4, rtol=1e-3)
    jcfg = hubert_jax.HubertConfig.from_hf_dict(cfg_dict)
    want = np.asarray(hubert_jax.forward(hubert_jax.convert_hf_state_dict(sd, jcfg), jcfg,
                                         jnp.asarray(f["wav"])[None], tap_layer=layer))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tap", [1, 3, None])
def test_post_norm_group_norm_forward_matches_jax(tap):
    cfg, jcfg = _tiny_postnorm_cfg(hubert), _tiny_postnorm_cfg(hubert_jax)
    params = hubert.random_params(cfg, seed=3)
    wav = np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)
    got = hubert.forward(to_torch(params), cfg, torch.from_numpy(wav), tap_layer=tap).numpy()
    want = np.asarray(hubert_jax.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                         jnp.asarray(wav), tap_layer=tap))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _jax_extractor(params, jcfg, centroids, layer):
    fe = JaxHubertFE.__new__(JaxHubertFE)
    fe.layer, fe.num_units, fe.bucket_samples = layer, centroids.shape[0], None
    fe.config = jcfg
    fe.params = jax.tree_util.tree_map(jnp.asarray, params)
    fe.centroids = jnp.asarray(centroids)
    fe._extract_jit = jax.jit(fe._extract_fn)
    return fe


def test_unit_ids_equal_jax(fixture):
    """Two wavs of different length in one zero-padded batch: the 40-sample
    pad, the tap, k-means and the relative trim, end to end."""
    f, cfg_dict, sd = fixture
    cfg, jcfg = HubertConfig.from_hf_dict(cfg_dict), hubert_jax.HubertConfig.from_hf_dict(cfg_dict)
    params = hubert.convert_hf_state_dict(sd, cfg)
    rng = np.random.default_rng(4)
    centroids = rng.standard_normal((N_UNITS, cfg.hidden_size)).astype(np.float32)
    lens = np.array([16000, 11000])
    wav = np.zeros((2, 16000), np.float32)
    wav[0] = f["wav"]
    wav[1, :11000] = rng.standard_normal(11000).astype(np.float32) * 0.1
    port = HubertFeatureExtractor.from_params(params, cfg, centroids, layer=3,
                                              device="cpu")
    got = port.extract(wav, lens)
    want = _jax_extractor(params, jcfg, centroids, layer=3).extract(wav, lens)
    assert [len(g) for g in got] == [len(w) for w in want] == [50, 35]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the same ids straight from JAX's forward + assign_clusters, padded by 40
    hidden = hubert_jax.forward(jax.tree_util.tree_map(jnp.asarray, params), jcfg,
                                jnp.pad(jnp.asarray(wav), ((0, 0), (40, 40))), tap_layer=3)
    ids = np.asarray(jax_assign(hidden, jnp.asarray(centroids)))
    np.testing.assert_array_equal(got[0], ids[0, :50])
    assert port.get_unit_duration() == 320 / 16000


def test_assign_clusters_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 50, 16)).astype(np.float32)
    c = rng.standard_normal((30, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        assign_clusters(torch.from_numpy(x), torch.from_numpy(c)).numpy(),
        np.asarray(jax_assign(jnp.asarray(x), jnp.asarray(c))))


def test_mhubert_25hz_preset_frames_and_unit_duration():
    jax_fe = JaxHubertFE(pretrained_model="slprl/mhubert-base-25hz", load_config_only=True,
                         cache_path="/nonexistent-cache-is-not-read")
    port = HubertFeatureExtractor(pretrained_model="slprl/mhubert-base-25hz",
                                  load_config_only=True, device="cpu")
    assert port.config.conv_stride == tuple(HUBERT_CONFIG_PRESETS[
        "slprl/mhubert-base-25hz"]["conv_stride"])
    assert len(port.config.conv_dim) == 8
    for n in (400, 640, 16000, 48000, 48001, 160000):
        assert port._n_frames(n) == jax_fe._n_frames(n), n
    assert port._n_frames(48000) == 75          # 3 s at 25 Hz
    assert port.get_unit_duration() == jax_fe.get_unit_duration() == 0.04


def test_kmeans_centroid_files(tmp_path):
    c = np.random.default_rng(0).standard_normal((7, 4)).astype(np.float32)
    np.save(tmp_path / "km.npy", c)
    np.savez(tmp_path / "km.npz", centroids=c)
    np.testing.assert_array_equal(load_kmeans_centroids(str(tmp_path / "km.npy")), c)
    np.testing.assert_array_equal(load_kmeans_centroids(str(tmp_path / "km.npz")), c)


def _to_fairseq(sd: dict) -> dict:
    """An HF HubertModel state dict (layer-norm extractor) in fairseq's layout."""
    out = {"mask_emb": np.zeros(4, np.float32), "final_proj.weight": np.zeros((2, 2), np.float32)}
    for k, v in sd.items():
        k = k.replace(".parametrizations.weight.original0", ".weight_g")
        k = k.replace(".parametrizations.weight.original1", ".weight_v")
        k = k.replace("encoder.pos_conv_embed.conv.", "encoder.pos_conv.0.")
        k = k.replace("feature_projection.layer_norm.", "layer_norm.")
        k = k.replace("feature_projection.projection.", "post_extract_proj.")
        k = re.sub(r"conv_layers\.(\d+)\.conv\.", r"conv_layers.\1.0.", k)
        k = re.sub(r"conv_layers\.(\d+)\.layer_norm\.", r"conv_layers.\1.2.1.", k)
        k = re.sub(r"(encoder\.layers\.\d+)\.layer_norm\.", r"\1.self_attn_layer_norm.", k)
        k = (k.replace(".attention.", ".self_attn.")
             .replace(".feed_forward.intermediate_dense.", ".fc1.")
             .replace(".feed_forward.output_dense.", ".fc2."))
        out[k] = torch.from_numpy(np.array(v))
    return out


def test_weight_loaders_match_jax(fixture, tmp_path):
    """A local HF directory (pytorch_model.bin + config.json) and a fairseq
    .pt of the same weights load into the trees the JAX converters build."""
    _, cfg_dict, sd = fixture
    jcfg = hubert_jax.HubertConfig.from_hf_dict(cfg_dict)
    want = hubert_jax.convert_hf_state_dict(sd, jcfg)

    def same(got):
        flat_g = jax.tree_util.tree_leaves_with_path(got)
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (p, g), (_, w) in zip(flat_g, flat_w):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6, atol=0,
                                       err_msg=str(p))

    hf = tmp_path / "hf"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps(cfg_dict))
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               hf / "pytorch_model.bin")
    params, cfg = hubert.load_hubert(str(hf), device="cpu")
    assert cfg.do_stable_layer_norm and cfg.feat_extract_norm == "layer"
    same(jax.tree_util.tree_map(lambda t: t.numpy(), params))

    state = {"model": _to_fairseq(sd), "cfg": {"model": {
        "conv_feature_layers": "[(32,10,5)] + [(32,3,2)] * 4 + [(32,2,2)] * 2",
        "extractor_mode": "layer_norm", "encoder_embed_dim": 64, "encoder_layers": 3,
        "encoder_attention_heads": 4, "encoder_ffn_embed_dim": 128, "conv_pos": 128,
        "conv_pos_groups": 16, "layer_norm_first": True, "conv_bias": False}}}
    got, cfg = hubert.convert_fairseq_state(state)
    jgot, jcfg2 = hubert_jax.convert_fairseq_state(state)
    assert cfg == HubertConfig.from_hf_dict(cfg_dict)
    assert dataclass_values(cfg) == dataclass_values(jcfg2)
    same(got)
    torch.save(state, tmp_path / "hubert.pt")
    params, _ = hubert.load_hubert(str(tmp_path / "hubert.pt"), device="cpu")
    same(jax.tree_util.tree_map(lambda t: t.numpy(), params))
    with pytest.raises(FileNotFoundError, match="nothing is"):
        hubert.load_hubert(str(tmp_path / "missing"), device="cpu")


def dataclass_values(cfg):
    import dataclasses

    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
