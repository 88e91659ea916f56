"""The port's CodeHiFiGAN against the JAX package's, on the CPU in float32.

The small config of tests/test_vocoder.py with seeded random weights in the
textless checkpoint's layout, converted by both packages. Tolerances:
waveforms and log durations rtol 1e-4, atol 1e-5, as the JAX package holds
its generator against torch's (float32 convolutions summed in another
order); durations exactly (round(exp(d) - 1) of log durations that agree to
~1e-6, away from the .5 boundaries at these seeds); the port's batched
synthesis against its own per-sample path within rtol 1e-5, atol 1e-7 (the
same convolutions on the same rows, which the CPU's convolution library may
block differently for a batch: a few float32 ulps).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.vocoder import hifigan_jax
from slamkit_tpu.vocoder.hifi_gan_vocoder import HiFiGANVocoder as JaxVocoder
from slamkit_tpu_torch.utils.tree import to_torch
from slamkit_tpu_torch.vocoder import HiFiGANVocoder, hifigan
from slamkit_tpu_torch.vocoder.checkpoint_manager import CheckpointManager

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TINY_CFG = {
    "model_in_dim": 8,
    "upsample_initial_channel": 16,
    "upsample_rates": [4, 2],
    "upsample_kernel_sizes": [8, 4],
    "resblock_kernel_sizes": [3, 5],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5]],
    "num_embeddings": 12,
    "embedding_dim": 8,
    "dur_predictor_params": {
        "encoder_embed_dim": 8, "var_pred_hidden_dim": 16,
        "var_pred_kernel_size": 3, "var_pred_dropout": 0.0,
    },
}
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def state_dict():
    sd = hifigan.random_state_dict(TINY_CFG, seed=0)
    # log durations around 1.2: units last 1-3 frames, so re-expansion runs
    sd["dur_predictor.proj.bias"] = np.array([1.2], np.float32)
    return sd


@pytest.fixture(scope="module")
def params(state_dict):
    return hifigan.convert_torch_generator(state_dict, TINY_CFG)


def _jax(tree):
    return jax.tree_util.tree_map(lambda a: None if a is None else jnp.asarray(a), tree,
                                  is_leaf=lambda a: a is None)


def test_generator_matches_jax(params):
    x = np.random.default_rng(0).standard_normal((2, 8, 17)).astype(np.float32)
    got = hifigan.generator_forward(to_torch(params), TINY_CFG, torch.from_numpy(x)).numpy()
    want = np.asarray(hifigan_jax.generator_forward(_jax(params), TINY_CFG, jnp.asarray(x)))
    assert got.shape == want.shape == (2, 1, 17 * 8)
    np.testing.assert_allclose(got, want, **TOL)


def test_variance_predictor_and_durations_match_jax(params):
    x = np.random.default_rng(1).standard_normal((1, 9, 8)).astype(np.float32)
    got = hifigan.variance_predictor(to_torch(params["dur_predictor"]),
                                     TINY_CFG["dur_predictor_params"], torch.from_numpy(x))
    want = np.asarray(hifigan_jax.variance_predictor(
        _jax(params["dur_predictor"]), TINY_CFG["dur_predictor_params"], jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    dur = hifigan.durations(got)
    np.testing.assert_array_equal(dur, np.maximum(np.round(np.exp(want) - 1).astype(int), 1))
    assert set(dur.ravel().tolist()) > {1}


@pytest.mark.parametrize("dur_prediction", [False, True])
def test_conditioning_and_code_forward_match_jax(params, dur_prediction):
    code = np.array([[1, 5, 3, 3, 7, 0, 11]])
    got = hifigan._build_conditioning(to_torch(params), TINY_CFG, code, dur_prediction)
    want = hifigan_jax._build_conditioning(_jax(params), TINY_CFG, code, dur_prediction)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    wav = hifigan.code_generator_forward(to_torch(params), TINY_CFG, code, dur_prediction)
    np.testing.assert_allclose(wav, hifigan_jax.code_generator_forward(
        _jax(params), TINY_CFG, code, dur_prediction), **TOL)


def test_synthesize_batch_equals_per_sample_and_jax(params):
    rng = np.random.default_rng(5)
    codes = [rng.integers(0, 12, size=(1, t)) for t in (7, 11, 7, 11, 7, 4)]
    tp = to_torch(params)
    got = hifigan.synthesize_batch(tp, TINY_CFG, codes, dur_prediction=True, max_batch=2)
    want = hifigan_jax.synthesize_batch(_jax(params), TINY_CFG, codes, dur_prediction=True,
                                        max_batch=2)
    for code, g, w in zip(codes, got, want):
        np.testing.assert_allclose(
            g, hifigan.code_generator_forward(tp, TINY_CFG, code, dur_prediction=True),
            rtol=1e-5, atol=1e-7)
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)


def _weight_normed(sd: dict) -> dict:
    """`sd` with every generator conv stored as weight_g / weight_v (torch's
    weight_norm over dim 0), as the textless checkpoints store them."""
    rng = np.random.default_rng(3)
    out = {}
    for k, w in sd.items():
        if k.endswith(".weight") and not k.startswith(("dict", "dur_predictor")):
            v = rng.standard_normal(w.shape).astype(np.float32)
            g = rng.uniform(0.5, 1.5, (w.shape[0],) + (1,) * (w.ndim - 1)).astype(np.float32)
            out[k[:-len("weight")] + "weight_g"] = g
            out[k[:-len("weight")] + "weight_v"] = v
        else:
            out[k] = w
    return out


def test_weight_norm_folding_matches_jax_and_torch(state_dict):
    sd = _weight_normed(state_dict)
    got = hifigan.convert_torch_generator(sd, TINY_CFG)
    want = hifigan_jax.convert_torch_generator(sd, TINY_CFG)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (p, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=str(p))
    v, g = (torch.from_numpy(sd[f"ups.0.weight_{s}"]) for s in "vg")
    np.testing.assert_allclose(got["ups"][0]["w"], torch._weight_norm(v, g, 0).numpy(),
                               rtol=1e-5, atol=1e-7)


def _jax_vocoder(params, cfg):
    voc = JaxVocoder.__new__(JaxVocoder)
    voc.params, voc.cfg = _jax(params), cfg
    voc.speakers = voc.styles = None
    voc.has_dur_predictor = "dur_predictor" in params
    voc.bucket_frames = None
    return voc


def test_vocoder_from_checkpoint_files_matches_jax(tmp_path, state_dict, params):
    """A textless-layout checkpoint file and its config json through the
    explicit-path constructor; empty and negative code lists map to empty
    waveforms in order."""
    torch.save({"generator": {k: torch.from_numpy(v) for k, v in
                              _weight_normed(state_dict).items()}}, tmp_path / "g.pt")
    (tmp_path / "config.json").write_text(json.dumps(TINY_CFG))
    voc = HiFiGANVocoder(model_path=str(tmp_path / "g.pt"),
                         config_path=str(tmp_path / "config.json"), device="cpu")
    assert voc.has_dur_predictor
    codes = [np.array([1, 2, 3]), np.array([-1, -2]), np.array([4, 5, 6, 7, 8])]
    got = voc.vocode_batch(codes)
    jparams = hifigan_jax.convert_torch_generator(_weight_normed(state_dict), TINY_CFG)
    want = _jax_vocoder(jparams, TINY_CFG).vocode_batch(codes)
    assert got[1].size == 0 and want[1].size == 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose(got[0], voc.vocode(codes[0]), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="config_path"):
        HiFiGANVocoder(model_path=str(tmp_path / "g.pt"), device="cpu")


def test_named_checkpoint_resolves_local_files_only(tmp_path):
    mgr = CheckpointManager(tmp_path)
    name = "mhubert-base-25hz-kmeans-500-hifigan"
    with pytest.raises(FileNotFoundError, match=str(tmp_path / "hifigan_lj_mhubert")):
        mgr.get_by_name(name)
    (tmp_path / "hifigan_lj_mhubert_base_25hz.pt").write_bytes(b"")
    assert mgr.get_by_name(name) == tmp_path / "hifigan_lj_mhubert_base_25hz.pt"
    with pytest.raises(KeyError):
        mgr.get_by_name("no-such-vocoder")
