"""The port's InterleavingTokeniser against the JAX package's, on the same
text-tokeniser directory and the same seeds, on the CPU.

  * train-mode strings of `random`, `span` and `poisson` interleaving, from
    the per-row Generator of `interleave_seed` and from numpy's global state;
  * test-mode strings, `get_ignore_tokens` for SPEECH, TEXT and None,
    `decode_sample` to units and to text, `prepare_batch`, `tokenise` and
    `build_prompt` (the JAX side padding as its SpeechLM sets it: right to
    score, left to prompt);
  * `tokenise` of GenerationInput lists whose speech segments of mixed
    lengths go through a tiny HuBERT carried across as
    `tests/test_torch_hubert.py` carries it: unit strings and ids equal;
  * the factory builds it from `config/tokeniser/interleaved_hubert_25.yaml`.
Everything is compared exactly: the same numpy draws, the same strings and
the same ids.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.feature_extractor import hubert_jax
from slamkit_tpu.feature_extractor.hubert_feature_extractor import \
    HubertFeatureExtractor as JaxHubertFE
from slamkit_tpu.tokeniser import interleaving_tokeniser as jax_il
from slamkit_tpu_torch.feature_extractor import HubertFeatureExtractor, hubert
from slamkit_tpu_torch.tokeniser import interleaving_tokeniser as port_il
from slamkit_tpu_torch.tools.sims_recipe import write_base_dir

pytest.importorskip("transformers")
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
N_UNITS = 20
N_WORDS = 60


class FakeFE:
    """5 units a second (0.2 s a unit), as tests/test_interleaving_tokeniser.py."""

    sample_rate = 16000
    bucket_samples = None

    def extract(self, wav, lens=None):
        wav = np.atleast_2d(np.asarray(wav))
        return [np.arange(int((lens[i] if lens is not None else wav.shape[1]) / 3200))
                % N_UNITS for i in range(wav.shape[0])]

    def get_unit_duration(self):
        return 0.2


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return write_base_dir(tmp_path_factory.mktemp("sims"), tiny=True, n_entries=N_WORDS + 4)


def _pair(base, fes=None, **params):
    """(port, JAX) tokenisers over one text tokeniser; `fes` their feature
    extractors (a FakeFE for both by default)."""
    port_fe, jax_fe = fes or (FakeFE(), FakeFE())
    kw = dict(num_units=N_UNITS, text_tokeniser_path=base, **params)
    return (port_il.InterleavingTokeniser(port_fe, **kw),
            jax_il.InterleavingTokeniser(jax_fe, **kw))


def _reps(seed=0, n=12):
    """Feature rows with aligned words covering their duration."""
    rng = np.random.default_rng(seed)
    reps = []
    for i in range(n):
        n_units = int(rng.integers(10, 60))
        dur = rng.integers(1, 4, n_units).tolist()
        total, words, t = sum(dur) * 0.2, [], 0.0
        while t < total:
            end = min(t + float(rng.uniform(0.1, 0.9)), total)
            words.append((f"w{int(rng.integers(N_WORDS))}", t, end))
            t = end
        reps.append({"file_name": f"f{i % 9}.wav",   # some names repeat
                     "units": rng.integers(0, N_UNITS, n_units).tolist(), "duration": dur,
                     "aligned_text": words})
    return reps


@pytest.mark.parametrize("method,span,prob", [("random", None, None), ("span", 3, 0.4),
                                              ("poisson", 4, 0.3)])
@pytest.mark.parametrize("seeded", [True, False])
def test_train_mode_strings_equal_jax(base, method, span, prob, seeded):
    port, ref = _pair(base, interleave_method=method, interleave_span=span,
                      interleave_prob=prob, interleave_seed=7 if seeded else None)
    reps = _reps()
    np.random.seed(3)
    got = port.stringify_representation(reps, mode="train")
    np.random.seed(3)
    want = ref.stringify_representation(reps, mode="train")
    assert got == want
    assert any("<speech>" in s for s in got) and any("<text>" in s for s in got)
    np.testing.assert_array_equal(port_il.select_spans_poisson(40, 3, 0.5,
                                                               np.random.default_rng(1)),
                                  jax_il.select_spans_poisson(40, 3, 0.5,
                                                              np.random.default_rng(1)))
    # stage 3 reads them with one encode call
    assert port.prepare_batch([{"audio_repr": s} for s in got]) == \
        ref.prepare_batch([{"audio_repr": s} for s in want])


def test_test_mode_ignore_tokens_decode_and_prompt(base):
    port, ref = _pair(base)
    reps = _reps(seed=1, n=4)
    assert port.stringify_representation(reps) == ref.stringify_representation(reps)
    assert len(port.text_tokeniser) == len(ref.text_tokeniser) == N_WORDS + 4 + N_UNITS + 2
    for mod in ("SPEECH", "TEXT", None, "speech"):
        assert port.get_ignore_tokens(mod) == ref.get_ignore_tokens(mod)
    rng = np.random.default_rng(2)
    for _ in range(6):
        ids = rng.integers(0, len(ref.text_tokeniser), 40)
        np.testing.assert_array_equal(port.decode_sample(ids, "SPEECH"),
                                      ref.decode_sample(ids, "SPEECH"))
        assert port.decode_sample(ids, "TEXT") == ref.decode_sample(ids, "TEXT")
    wav = rng.standard_normal((2, 32000)).astype(np.float32)
    lens = np.array([32000, 16000])
    got, want = port.tokenise(wav, lens), ref.tokenise(wav, lens)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    inputs = [[("TEXT", "w1 w2 w3"), ("SPEECH", wav[0, :9600])],
              [("SPEECH", wav[1]), ("TEXT", "w9")]]
    ref.text_tokeniser.padding_side = "left"      # as the JAX SpeechLM sets it
    for mod in ("SPEECH", "TEXT", None):
        got, want = port.build_prompt(inputs, output_modality=mod), \
            ref.build_prompt(inputs, output_modality=mod)
        assert sorted(got) == ["attention_mask", "input_ids"]
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=f"{mod} {key}")
    ref.text_tokeniser.padding_side = "right"
    with pytest.raises(ValueError, match="modality"):
        port.build_prompt(inputs, output_modality="video")


def _tiny(mod):
    """A post-norm HuBERT of 4 convs (stride 80) and 3 layers, 32 wide."""
    return mod.HubertConfig(conv_dim=(16,) * 4, conv_kernel=(10, 3, 3, 2),
                            conv_stride=(5, 2, 2, 2), hidden_size=32, num_hidden_layers=3,
                            num_attention_heads=4, intermediate_size=64,
                            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)


def _extractors(layer=2):
    """The tiny HuBERT and 20 centroids drawn from its features, in both
    packages."""
    cfg, jcfg = _tiny(hubert), _tiny(hubert_jax)
    params = hubert.random_params(cfg, seed=3)
    rng = np.random.default_rng(5)
    probe = HubertFeatureExtractor.from_params(params, cfg, np.zeros((N_UNITS, 32), np.float32),
                                               layer=layer, device="cpu")
    feats = probe.features(torch.from_numpy(
        rng.standard_normal((2, 8000)).astype(np.float32)))[0].numpy()
    centroids = feats[rng.choice(len(feats), N_UNITS, replace=False)]
    port = HubertFeatureExtractor.from_params(params, cfg, centroids, layer=layer, device="cpu")
    ref = JaxHubertFE.__new__(JaxHubertFE)
    ref.layer, ref.num_units, ref.bucket_samples = layer, N_UNITS, None
    ref.config = jcfg
    ref.params = jax.tree_util.tree_map(jnp.asarray, params)
    ref.centroids = jnp.asarray(centroids)
    ref._extract_jit = jax.jit(ref._extract_fn)
    return port, ref


def test_generation_inputs_through_hubert_equal_jax(base):
    port_fe, ref_fe = _extractors()
    port, ref = _pair(base, fes=(port_fe, ref_fe))
    rng = np.random.default_rng(6)
    wav = lambda n: (0.3 * rng.standard_normal(n)).astype(np.float32)
    batch = [[port_il.GenerationInput("w3 w4", port_il.ContentType.TEXT),
              port_il.GenerationInput(wav(6400), port_il.ContentType.SPEECH)],
             [port_il.GenerationInput(wav(9600), port_il.ContentType.SPEECH),
              port_il.GenerationInput("w5", port_il.ContentType.TEXT),
              port_il.GenerationInput(wav(6400), port_il.ContentType.SPEECH)],
             [port_il.GenerationInput(wav(12000), port_il.ContentType.SPEECH)]]
    ref_batch = [[jax_il.GenerationInput(g.content, jax_il.ContentType[g.content_type.value])
                  for g in row] for row in batch]
    got = port._stringify_interleaved_batch(batch)
    want = ref._stringify_interleaved_batch(ref_batch)
    assert got == want and all("<Un" in s for s in got)
    # one segment alone gives the units it gives inside the batch
    assert port._stringify_interleaved([batch[2][0]]) == \
        "<speech>" + got[2].split("<speech>")[1]
    g, w = port.tokenise(batch), ref.tokenise(ref_batch)
    for key in ("input_ids", "attention_mask"):
        np.testing.assert_array_equal(g[key], w[key])


def test_factory_builds_it_from_the_config(base):
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.tokeniser import tokeniser_factory

    cfg = compose(str(REPO_ROOT / "config"), "prepare_tokens",
                  ["tokeniser=interleaved_hubert_25", f"tokeniser.params.text_tokeniser_path={base}",
                   "data_path=-", "out_path=-"])
    tok = tokeniser_factory(cfg.tokeniser, device="cpu")
    assert isinstance(tok, port_il.InterleavingTokeniser)
    assert (tok.interleave_method, tok.interleave_span, tok.interleave_prob) == ("poisson", 10,
                                                                                 0.3)
    assert tok.num_units == 500 and len(tok.text_tokeniser) == N_WORDS + 4 + 502
    assert tok.speech_fe.get_unit_duration() == 0.04
