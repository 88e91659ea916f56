"""GenPPL and the LLM judge on the port against the JAX package, on the CPU.

Fixtures: `tools/genppl_recipe.py`'s tiny Whisper (whisper-large-v3-turbo's
vocabulary, ids and generation config at 32 wide) and tiny Llama-3.2 layout
(its 128256-id byte-level BPE tokenizer.json and config.json at 64 wide, 2
layers, F16 weights), and test_torch_speech_lm.py's SpeechLM (the fixture
HuBERT, a seeded k-means, a tiny Qwen2-layout UnitLM and a tiny
CodeHiFiGAN), with greedy generate_kwargs. The JAX side runs its own stack
(`asr_backend="jax"`, `llm_backend="jax"`: whisper_jax and its UnitLM) with
transformers' tokenizers and feature extractor on the same directories.

Tolerances: per-text mean NLL 1e-5 absolute (float32 decoders on both
sides); asr_perplexity 1e-4 relative (exp of a mean of such NLLs, and the
texts themselves exact); transcripts, auto-BLEU, prompt ids, masks,
instruction texts and scores exactly.
"""
import json
import os
import pathlib

import numpy as np
import pytest
import torch

from slamkit_tpu.metric import generative_metric as jax_metric
from slamkit_tpu.metric import metric_utils as jax_utils
from slamkit_tpu_torch.metric import generative_metric, metric_utils
from slamkit_tpu_torch.tools import genppl_recipe
from slamkit_tpu_torch.utils.audio import save_wav
from test_torch_speech_lm import GEN, _jax, _port, parts  # noqa: F401  (a fixture)

transformers = pytest.importorskip("transformers")
pytest.importorskip("nltk")

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TEXTS = ["Hello there, how are you today?", "a", "", "naïve café — 3,000 words... ok!",
         "the the the the the the the the the the the the the the the the"]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("genppl")
    return dict(whisper=genppl_recipe.write_whisper_dir(root / "whisper", tiny=True),
                llama=genppl_recipe.write_llama_dir(root / "llama", tiny=True))


@pytest.fixture(scope="module")
def llms(dirs):
    port = metric_utils.get_llm(dirs["llama"], device="cpu")
    ref = jax_utils.get_llm(dirs["llama"], backend="jax")
    return port, ref


def test_llm_perplexity_matches_jax(llms):
    (model, tok), (jmodel, jtok) = llms
    assert model.decoder.cfg.dtype == "float32" and model.config.pad_token_id == 128001
    assert tok.pad_token_id == jtok.pad_token_id == 128001
    got = metric_utils.get_llm_perplexity(model, tok, TEXTS)
    want = np.asarray(jax_utils.get_llm_perplexity(jmodel, jtok, TEXTS))
    assert got.shape == (len(TEXTS),) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert metric_utils.get_llm_preplexity is metric_utils.get_llm_perplexity


def test_llm_config_is_llama_1b_at_full_width(tmp_path):
    """The full directory's config (no weights read): Llama-3.2-1B's shape,
    the llama3 rope_scaling block left unread, as the JAX package leaves it."""
    from slamkit_tpu_torch.models.presets import PRESETS, resolve_base_config

    folder = tmp_path / "llama"
    folder.mkdir()
    cfg = {"model_type": "llama", "vocab_size": 128256, "max_position_embeddings": 131072,
           "rope_theta": 500000.0, "tie_word_embeddings": True, **genppl_recipe.LLAMA_1B}
    (folder / "config.json").write_text(json.dumps(cfg))
    got = resolve_base_config(str(folder))
    want = PRESETS["meta-llama/Llama-3.2-1B"]
    for k in ("hidden_size", "num_layers", "num_heads", "num_kv_heads", "head_dim",
              "intermediate_size", "vocab_size", "rope_theta", "tie_word_embeddings"):
        assert getattr(got, k) == want[k], k


def test_depth_cut_keeps_the_widths(tmp_path):
    """`encoder_layers` / `num_layers` cut only the depth (phase 16 writes
    whisper-large-v3-turbo and Llama-3.2-1B so): every other config field
    and every weight shape stay the uncut directory's."""
    from slamkit_tpu_torch.utils.safetensors import read_safetensors

    def written(write, name, **cut):
        folder = pathlib.Path(write(tmp_path / name, tiny=True, **cut))
        return (json.loads((folder / "config.json").read_text()),
                {k: v.shape for k, v in
                 read_safetensors(str(folder / "model.safetensors")).items()})

    for write, key, cut, layer in (
            (genppl_recipe.write_whisper_dir, "encoder_layers", "encoder_layers",
             "model.encoder.layers."),
            (genppl_recipe.write_llama_dir, "num_hidden_layers", "num_layers",
             "model.layers.")):
        full_cfg, full = written(write, f"{key}_full")
        cfg, got = written(write, f"{key}_cut", **{cut: 1})
        assert full_cfg[key] == 2 and cfg[key] == 1
        assert {k: v for k, v in cfg.items() if v != full_cfg[k]} == {
            k: 1 for k in (key, "num_hidden_layers")}
        assert got == {k: v for k, v in full.items() if not k.startswith(layer + "1.")}


def test_get_llm_raises_without_weights(dirs, tmp_path):
    for name in ("config.json", "tokenizer.json", "tokenizer_config.json"):
        (tmp_path / name).write_bytes(open(os.path.join(dirs["llama"], name), "rb").read())
    with pytest.raises(FileNotFoundError, match="no weights"):
        metric_utils.get_llm(str(tmp_path), device="cpu")


@pytest.mark.parametrize("kind", ["asr_backend", "llm_backend"])
def test_backends_name_the_ports_own_implementations(kind):
    metric_utils.check_backend(kind, "torch")
    metric_utils.check_backend(kind, "jax")
    with pytest.raises(NotImplementedError, match=kind):
        metric_utils.check_backend(kind, "hf")


@pytest.mark.parametrize("text", [
    "The final answer is $\\boxed{4}$", "no box here", "\\boxed{12} then \\boxed{3}",
    "\\boxed{ 5}", "\\boxed{x}", "", "answer: \\boxed{007}."])
def test_extract_digit_from_boxed_equals_jax(text):
    assert metric_utils.extract_digit_from_boxed(text) == jax_utils.extract_digit_from_boxed(text)


class Stub:
    """Records generate's inputs; returns them followed by fixed ids that
    decode to a boxed rating."""

    def __init__(self, tail):
        self.tail, self.calls = np.asarray(tail), []

    def generate(self, ids, attention_mask=None, **kwargs):
        ids, mask = np.asarray(ids), np.asarray(attention_mask)
        self.calls.append((ids, mask, kwargs))
        tails = np.stack([np.roll(self.tail, i) for i in range(len(ids))])
        return torch.from_numpy(np.concatenate([ids, tails], axis=1).astype(np.int64))

    log_likelihood = None


def test_judge_text_prompts_padding_and_scores_equal_jax(llms):
    (_, tok), (_, jtok) = llms
    tail = tok("The final answer is $\\boxed{4}$", add_special_tokens=False)["input_ids"]
    texts = ["Rate: \"a b c\" then \"d\".", "short", TEXTS[3]]
    port, ref = Stub(tail), Stub(tail)
    got = metric_utils.judge_text(port, tok, texts)
    want = jax_utils.judge_text(ref, jtok, texts)
    assert got == want and got[0] == 4
    (ids, mask, kw), (jids, jmask, jkw) = port.calls[0], ref.calls[0]
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)
    assert tok.padding_side == jtok.padding_side == "left" and mask[1, 0] == 0
    assert {k: kw[k] for k in ("max_new_tokens", "do_sample", "temperature")} == jkw


def test_get_judge_sets_eos_and_pad(dirs):
    judge = metric_utils.get_judge(dirs["llama"], "cpu", batch_size=2)
    ref = jax_utils.get_judge(dirs["llama"], "cpu", batch_size=2, backend="jax")
    assert judge.model.config.eos_token_id == ref.model.config.eos_token_id == 128001
    assert judge.model.config.pad_token_id == ref.model.config.pad_token_id == 128001
    # real sampling runs: 512 new tokens a row from the caller's generator,
    # scores or None, the same twice from the same seed
    runs = [metric_utils.LLMJudge(judge.model, judge.tokeniser, "cpu", 2,
                                  generator=torch.Generator().manual_seed(0))(
        ["Rate this: \\boxed{", "x"]) for _ in range(2)]
    assert len(runs[0]) == 2 and runs[0] == runs[1]


def test_openai_judge_names_the_missing_package(monkeypatch):
    """OpenAI judge names go to OpenAIJudge, which imports openai only when
    built, and says so where it is missing (as on the card's host)."""
    monkeypatch.setitem(__import__("sys").modules, "openai", None)
    for name in metric_utils.OPENAI_MODELS:
        with pytest.raises(ImportError, match="openai package"):
            metric_utils.get_judge(name, "cpu", batch_size=1)


# --------------------------------------------------------------------------- #
# end to end
# --------------------------------------------------------------------------- #
def _recorded(monkeypatch, module):
    """Wraps the module's `_transcribe` and `get_llm_perplexity`."""
    seen = {"texts": [], "nll": []}
    transcribe, ppl = module._transcribe, module.get_llm_perplexity

    def rec_transcribe(*a, **k):
        out = transcribe(*a, **k)
        seen["texts"].append(list(out))
        return out

    def rec_ppl(*a, **k):
        out = ppl(*a, **k)
        seen["nll"].append(np.asarray(out))
        return out

    monkeypatch.setattr(module, "_transcribe", rec_transcribe)
    monkeypatch.setattr(module, "get_llm_perplexity", rec_ppl)
    return seen


def test_asr_perplexity_matches_jax(parts, dirs, monkeypatch):  # noqa: F811
    kw = dict(batch_size=2, whisper_model=dirs["whisper"], llm_name_or_path=dirs["llama"],
              prompt_length=0.5, num_workers=2, torch_device="cpu", **GEN)
    seen = _recorded(monkeypatch, generative_metric)
    jseen = _recorded(monkeypatch, jax_metric)
    got = generative_metric.asr_perplexity(_port(parts), parts["glob"], **kw)
    want = jax_metric.asr_perplexity(_jax(parts), parts["glob"], asr_backend="jax",
                                     llm_backend="jax", **kw)
    assert seen["texts"] == jseen["texts"] and sum(map(len, seen["texts"])) == 3
    assert all(t for batch in seen["texts"] for t in batch)
    for a, b in zip(seen["nll"], jseen["nll"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert np.isfinite(got["asr_perplexity"]) and got["asr_perplexity"] > 0
    np.testing.assert_allclose(got["asr_perplexity"], want["asr_perplexity"], rtol=1e-4)
    assert got["auto-belu-2"] == want["auto-belu-2"]
    assert len(got["generate"]) == len(got["prompts"]) == 3


def test_llm_as_judge_matches_jax(parts, dirs, monkeypatch):  # noqa: F811
    """Transcripts and instruction texts equal; the judge's sampled output is
    stubbed identically on both sides (jax.random cannot be reproduced)."""
    judged = {"port": [], "jax": []}

    def stub_judge(side):
        def get_judge(name, device, batch_size, backend="torch", **kw):
            def judge(texts):
                judged[side].extend(texts)
                return [len(t) % 5 + 1 if i % 2 == 0 else None for i, t in enumerate(texts)]
            return judge
        return get_judge

    monkeypatch.setattr(generative_metric, "get_judge", stub_judge("port"))
    monkeypatch.setattr(jax_metric, "get_judge", stub_judge("jax"))
    instruction = ("Prompt: \"[prompt_audio_transcription]\", continuation: "
                   "\"[generated_audio_transcription]\". \\boxed{x}")
    kw = dict(batch_size=2, whisper_model=dirs["whisper"], llm_name_or_path=dirs["llama"],
              instruction=instruction, prompt_length=0.5, num_workers=2, torch_device="cpu",
              **GEN)
    got = generative_metric.llm_as_judge(_port(parts), parts["glob"], **kw)
    want = jax_metric.llm_as_judge(_jax(parts), parts["glob"], asr_backend="jax",
                                   llm_backend="jax", **kw)
    assert judged["port"] == judged["jax"] and len(judged["port"]) == 3
    assert got["audio_transcription"] == want["audio_transcription"]
    assert got["llm_as_judge"] == want["llm_as_judge"]
    assert all("[prompt_audio" not in t for t in judged["port"])


# --------------------------------------------------------------------------- #
# alignment prompts (use_alignment: true, llm_as_judge.yaml's setting)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("layout", ["folder", "beside"])
def test_alignment_prompts_crop_as_jax(tmp_path, layout):
    """An alignment folder (`<stem>.json` per WAV) or a `.json` beside each
    `.wav`: both packages' PromptDataset crop each prompt at the word end
    closest to prompt_length, from the same alignment file."""
    rng = np.random.default_rng(4)
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    wavs, seconds = [], []
    for i in range(4):
        s = float(rng.uniform(1.5, 4.0))
        path = wav_dir / f"utt{i}.v1.wav"
        save_wav(str(path), (0.1 * rng.standard_normal(int(s * 16000))).astype(np.float32))
        wavs.append(str(path))
        seconds.append(s)
    folder = tmp_path / "align" if layout == "folder" else wav_dir
    genppl_recipe.write_alignments(folder, wavs, seconds)
    if layout == "beside":      # `file.replace(".wav", ".json")`: utt0.v1.json
        for w in wavs:
            os.replace(folder / (os.path.basename(w).split(".")[0] + ".json"),
                       w.replace(".wav", ".json"))
    kw = dict(prompt_length=1.0, use_alignment=True,
              alignment_folder=str(folder) if layout == "folder" else None)
    port = generative_metric.PromptDataset(str(wav_dir / "*.wav"), **kw)
    ref = jax_metric.PromptDataset(str(wav_dir / "*.wav"), **kw)
    assert port.data == ref.data and len(port) == 4
    for i in range(4):
        path = port.get_alignment_path(port.data[i])
        assert path == ref.get_alignment_path(ref.data[i]) and os.path.isfile(path)
        with open(path) as f:
            alignment = json.load(f)["aligned_text"]
        cut = generative_metric.get_cut_location(alignment, 1.0)
        assert cut == jax_metric.get_cut_location(alignment, 1.0)
        assert cut in [w[2] for w in alignment] and abs(cut - 1.0) <= 0.6
        got, want = port[i], ref[i]
        np.testing.assert_array_equal(got, want)
        assert len(got) == int(cut * 16000)
