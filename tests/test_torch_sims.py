"""The SIMS recipe on the port against the JAX package, on the CPU at a tiny
size (scripts/rehearse_sims.py --tiny's 4-layer, 64-wide base; a WordLevel
tokenizer of 64 entries written by `tools/sims_recipe.py`).

  * `interleave` of three seeded corpora, both stopping strategies, with and
    without `repetitions`: the same rows bit for bit;
  * `init_dataset` on a list `train_path` through both interleaving
    tokenisers (load_fe: false): train and validation rows and the packed
    batches of the Batcher bit for bit;
  * `cli.prepare_tokens tokeniser=interleaved_hubert_25` with `meta_path`
    and `interleave_seed`: output byte-identical to the JAX CLI's;
  * `cli.train --config-name train_inter_scale` for 3 steps from one
    JAX-written checkpoint, float32, context 128, with the token accounting
    restricted to the unit ids (`min_token_id_count` / `max_token_id_count`):
    losses and learning rates as test_torch_cli.py holds them (1e-4 and 1e-6
    relative), the token counts equal. The JAX CLI runs on the suite's 8
    virtual devices, so its per-device batch of 1 is the port's 8;
  * `cli.eval metric=cm_ms_tsc` (TEXT prompt, SPEECH continuations) and
    `metric=cm_generate`, greedy, TEXT->SPEECH through
    `vocoder=vocoder_hubert_25` and SPEECH->TEXT with `.txt` outputs: every
    log-likelihood within 1e-4 absolute, the printed score equal, every
    generated id equal, the waveforms within 1e-4 and the text files equal.
"""
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from slamkit_tpu_torch.tools import sims_recipe

transformers = pytest.importorskip("transformers")
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
N_ENTRIES = 64                          # 4 specials + 60 words
VOCAB = N_ENTRIES + 502                 # + 500 units, <speech>, <text>
TINY_VOCODER = {"model_in_dim": 8, "num_embeddings": 500, "embedding_dim": 8,
                "upsample_initial_channel": 16, "upsample_rates": [4, 2],
                "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
                "resblock_dilation_sizes": [[1, 3], [1, 3]],
                "dur_predictor_params": {"encoder_embed_dim": 8, "var_pred_hidden_dim": 8,
                                         "var_pred_kernel_size": 3,
                                         "var_pred_dropout": 0.5}}


def _jax_cli(name: str):
    mod_name = f"_jax_cli_{name}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, REPO_ROOT / "cli" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The tiny base, three corpora and two validation corpora of 60 words,
    and one JAX-written float32 checkpoint over the interleaved vocabulary."""
    from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
    from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig

    d = tmp_path_factory.mktemp("sims")
    base = sims_recipe.write_base_dir(d, tiny=True, n_entries=N_ENTRIES)
    (d / "train").mkdir()
    (d / "val").mkdir()
    sims_recipe.write_corpora(d / "train", 24, lengths=(20, 160), n_words=60)
    sims_recipe.write_corpora(d / "val", 3, lengths=(20, 100), n_words=60, seed=1)
    JaxUnitLM(JaxUnitLMConfig(base_model_name=base, vocab_size=VOCAB, twist_init=False,
                              torch_dtype="float32"), seed=0).save_pretrained(str(d / "ckpt"))
    return d


def _corpora(d, split="train"):
    return [str(d / split / f"{n}.jsonl") for n in ("text", "inter", "speech")]


# --------------------------------------------------------------------------- #
# multi-corpus mixing
# --------------------------------------------------------------------------- #
def _datasets(mod, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in (7, 30, 13):
        seqs = [rng.integers(0, 500, int(rng.integers(1, 40))).tolist() for _ in range(n)]
        out.append(mod.TokenDataset.from_lists(seqs))
    return out


@pytest.mark.parametrize("strategy", ["first_exhausted", "all_exhausted"])
@pytest.mark.parametrize("reps", [None, (2, 1, 3)])
def test_interleave_equals_jax(strategy, reps):
    from slamkit_tpu.data import dataset as jax_ds
    from slamkit_tpu_torch.data import dataset as port_ds

    ratios = [0.2, 0.5, 0.3]
    mixed = []
    for mod in (port_ds, jax_ds):
        parts = _datasets(mod)
        if reps:
            parts = [p.repeat(r) for p, r in zip(parts, reps)]
        mixed.append(mod.interleave(parts, ratios, stopping_strategy=strategy, seed=0))
    got, want = mixed
    assert len(got) == len(want) > 0
    np.testing.assert_array_equal(got.lengths, want.lengths)
    np.testing.assert_array_equal(got.starts, want.starts)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    # a source with ratio 0 is never drawn; all_exhausted still ends
    got0 = port_ds.interleave(_datasets(port_ds), [0.0, 0.5, 0.5], stopping_strategy=strategy)
    want0 = jax_ds.interleave(_datasets(jax_ds), [0.0, 0.5, 0.5], stopping_strategy=strategy)
    np.testing.assert_array_equal(got0.tokens, np.asarray(want0.tokens))


def _compose(compose, d, extra=()):
    return compose(str(REPO_ROOT / "config"), "train_inter_scale", [
        f"data.train_path=[{','.join(_corpora(d))}]",
        f"data.val_path=[{','.join(_corpora(d, 'val')[:2])}]",
        f"model.config_args.base_model_name={d / 'base'}",
        f"tokeniser.params.text_tokeniser_path={d / 'base'}", "model.context_len=128",
        *extra])


def test_init_dataset_on_a_list_equals_jax(work):
    from slamkit_tpu.config import compose as jax_config
    from slamkit_tpu.data import dataset as jax_ds
    from slamkit_tpu.tokeniser import tokeniser_factory as jax_factory
    from slamkit_tpu_torch.config import compose as port_config
    from slamkit_tpu_torch.data import dataset as port_ds
    from slamkit_tpu_torch.tokeniser import tokeniser_factory

    extra = ["data.repetitions=[1,2,1]", "data.chunk_units_min_length=4"]
    cfg, jcfg = _compose(port_config, work, extra), _compose(jax_config, work, extra)
    tok, jtok = tokeniser_factory(cfg.tokeniser, device="cpu"), jax_factory(jcfg.tokeniser)
    got, want = port_ds.init_dataset(cfg, tok), jax_ds.init_dataset(jcfg, jtok)
    assert sorted(got) == sorted(want) == ["train", "validation"]
    for split in got:
        assert len(got[split]) == len(want[split]) > 0
        for i in range(len(got[split])):
            np.testing.assert_array_equal(got[split][i], np.asarray(want[split][i]))
    ids = np.concatenate([got["train"][i] for i in range(len(got["train"]))])
    assert (ids >= N_ENTRIES).any() and (ids < N_ENTRIES).any()     # units and words
    batches = []
    for mod, ds in ((port_ds, got), (jax_ds, want)):
        b = mod.Batcher(ds["train"], batch_size=4, context_len=128, pad_id=0, packing=True,
                        seed=0, packing_strategy="bestfit")
        batches.append(list(b.epoch(1)))
    assert len(batches[0]) == len(batches[1]) > 1
    for a, b in zip(*batches):
        for key in ("input_ids", "labels", "segment_ids", "positions", "num_items_in_batch"):
            np.testing.assert_array_equal(a[key], np.asarray(b[key]), err_msg=key)


# --------------------------------------------------------------------------- #
# stage 2
# --------------------------------------------------------------------------- #
def test_prepare_tokens_with_meta_equals_jax(work, tmp_path):
    from slamkit_tpu_torch.cli import prepare_tokens as port_prepare

    rng = np.random.default_rng(7)
    features = tmp_path / "features.jsonl"
    with open(features, "w") as f:
        for i in range(20):
            n = int(rng.integers(5, 80))
            f.write(json.dumps({"file_name": f"/data/utt{i}.wav",
                                "units": rng.integers(0, 500, n).tolist(),
                                "duration": rng.integers(1, 4, n).tolist()}) + "\n")
    meta = sims_recipe.write_alignments(tmp_path / "align", features, unit_duration=0.04,
                                        n_words=60)
    (tmp_path / "align" / "utt3.json").unlink()                 # a file without one
    outs = []
    for name, run, extra in (("port", port_prepare.prepare_tokens, ["+device=cpu"]),
                             ("jax", _jax_cli("prepare_tokens").prepare_tokens, [])):
        out = tmp_path / f"{name}.jsonl"
        run([f"data_path={features}", f"out_path={out}", "tokeniser=interleaved_hubert_25",
             f"tokeniser.params.text_tokeniser_path={work / 'base'}", f"meta_path={meta}",
             "+tokeniser.params.interleave_seed=0", "n_threads=4", *extra])
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    lines = outs[0].decode().splitlines()
    assert len(lines) == 19 and all("<speech>" in ln or "<text>" in ln for ln in lines)
    assert any("<Un" in ln and "<text>w" in ln for ln in lines)


# --------------------------------------------------------------------------- #
# stage 3
# --------------------------------------------------------------------------- #
def _train_overrides(d, out, per_device, **extra):
    first_unit = N_ENTRIES       # <Un0>; the units end at N_ENTRIES + 499
    ov = {"data.train_path": f"[{','.join(_corpora(d))}]",
          "data.val_path": f"[{','.join(_corpora(d, 'val'))}]",
          "model.pretrained_model": d / "ckpt", "model.context_len": 128,
          "model.config_args.base_model_name": d / "base",
          "model.config_args.twist_init": "false", "model.config_args.torch_dtype": "float32",
          "logger": "print", "training_args.output_dir": out, "training_args.max_steps": 3,
          "training_args.per_device_train_batch_size": per_device,
          "training_args.per_device_eval_batch_size": per_device,
          "training_args.logging_steps": 1, "training_args.save_steps": 3,
          "training_args.eval_steps": 3, "training_args.warmup_steps": 1,
          "training_args.remat": "true",
          "training_args.min_token_id_count": first_unit,
          "training_args.max_token_id_count": first_unit + 499, **extra}
    return ["--config-name", "train_inter_scale"] + [f"{k}={v}" for k, v in ov.items()]


def _history(out, step):
    return json.loads((pathlib.Path(out) / f"checkpoint-{step}" /
                       "trainer_state.json").read_text())["log_history"]


def _pick(history, key):
    return [r[key] for r in history if key in r]


def test_train_cli_on_train_inter_scale_matches_jax(work):
    from slamkit_tpu_torch.cli import train as port_train

    state = port_train.train(_train_overrides(
        work, work / "port", 8, **{"training_args.use_cpu": "true"}))
    _jax_cli("train").train(_train_overrides(
        work, work / "jax", 1, **{"model.config_args.attn_implementation": "null"}))
    got, want = _history(work / "port", 3), _history(work / "jax", 3)
    assert state.global_step == 3 and len(_pick(got, "loss")) == 3
    np.testing.assert_allclose(_pick(got, "loss"), _pick(want, "loss"), rtol=1e-4)
    np.testing.assert_allclose(_pick(got, "eval_loss"), _pick(want, "eval_loss"), rtol=1e-4)
    np.testing.assert_allclose(_pick(got, "learning_rate"), _pick(want, "learning_rate"),
                               rtol=1e-6)
    # only unit ids count toward the token budget, identically on both sides
    seen = _pick(got, "num_input_tokens_seen")
    assert seen == _pick(want, "num_input_tokens_seen") and 0 < seen[0]
    saved = json.loads((work / "port" / "checkpoint-3" / "unit_lm_config.json").read_text())
    assert saved["vocab_size"] == VOCAB and saved["attn_implementation"] == "flash_attention_2"


def test_token_count_bounds_take_the_unit_ids(work, tmp_path):
    """min/max_token_id_count over the interleaved vocabulary: a step counts
    exactly the batch's labels that are unit ids."""
    from slamkit_tpu_torch.cli import train as port_train
    from slamkit_tpu_torch.trainer import slam_trainer

    counted = []
    original = slam_trainer.SLAMTrainer._count_tokens

    def record(self, labels):
        n = original(self, labels)
        labels = np.asarray(labels)
        counted.append((int(n), int(((labels >= N_ENTRIES) & (labels < N_ENTRIES + 500)).sum()),
                        int((labels != -100).sum())))
        return n

    slam_trainer.SLAMTrainer._count_tokens = record
    try:
        port_train.train(_train_overrides(work, tmp_path / "o", 8, **{
            "training_args.use_cpu": "true", "training_args.max_steps": 1}))
    finally:
        slam_trainer.SLAMTrainer._count_tokens = original
    assert counted and all(n == units < labels for n, units, labels in counted)


# --------------------------------------------------------------------------- #
# stage 4
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def eval_files(work):
    """A tiny random HuBERT saved by transformers, 500 centroids drawn from
    its features, 6 cross-modal triples, 4 text prompts, 4 WAV prompts and
    the tiny CodeHiFiGAN as vocoder_hubert_25's files."""
    from slamkit_tpu_torch.feature_extractor.hubert import forward, load_hf_dir
    from slamkit_tpu_torch.utils.audio import load_audio
    from slamkit_tpu_torch.utils.tree import to_torch

    cm = sims_recipe.write_cm_triples(work / "cm", 6, seconds=(0.3, 0.6), n_words=60)
    sims_recipe.write_text_prompts(work / "prompts", 4, n_words=60)
    torch.manual_seed(0)
    transformers.HubertModel(transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4),
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4)).save_pretrained(
        work / "hubert")
    params, cfg = load_hf_dir(str(work / "hubert"))
    params = to_torch(params, torch.device("cpu"))
    wavs = sorted(pathlib.Path(cm).glob("*.wav"))
    frames = np.concatenate([forward(params, cfg, torch.from_numpy(load_audio(str(p)))[None],
                                     tap_layer=2)[0].numpy() for p in wavs])
    rng = np.random.default_rng(3)
    np.save(work / "km.npy", frames[rng.choice(len(frames), 500)].astype(np.float32))
    sims_recipe.write_textless_vocoder(work / "textless", TINY_VOCODER)
    return work


def _eval_overrides(d, *extra):
    return [f"model.pretrained_model={d / 'ckpt'}", "model.config_args.torch_dtype=float32",
            "tokeniser=interleaved_hubert_25",
            f"tokeniser.params.text_tokeniser_path={d / 'base'}",
            f"tokeniser.feature_extractor.pretrained_model={d / 'hubert'}",
            f"tokeniser.feature_extractor.kmeans_path={d / 'km.npy'}",
            "tokeniser.feature_extractor.layer=2", "batch_size=3", "num_workers=2",
            "device=cpu", *extra]


def _recording(monkeypatch, cls, name, record):
    original = getattr(cls, name)

    def wrapped(self, *args, **kwargs):
        out = original(self, *args, **kwargs)
        record.append(np.asarray(out.numpy() if isinstance(out, torch.Tensor) else out))
        return out

    monkeypatch.setattr(cls, name, wrapped)


def test_eval_cli_cm_storycloze_matches_jax(eval_files, monkeypatch, capsys):
    from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
    from slamkit_tpu_torch.cli import eval as port_eval
    from slamkit_tpu_torch.models import UnitLM

    ov = _eval_overrides(eval_files, "metric=cm_ms_tsc", f"metric.data_path={eval_files / 'cm'}",
                         "metric.subfolder=false", "metric.prompt_modality=TEXT",
                         "metric.cont_modality=SPEECH")
    got, want = [], []
    _recording(monkeypatch, UnitLM, "log_likelihood", got)
    _recording(monkeypatch, JaxUnitLM, "log_likelihood", want)
    capsys.readouterr()
    res = port_eval.eval_main(ov)
    port_out = capsys.readouterr().out
    _jax_cli("eval").eval_main(ov)
    jax_out = capsys.readouterr().out
    assert len(got) == len(want) == 4                 # 2 batches x (correct, incorrect)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4)
    line = lambda out: [ln for ln in out.splitlines() if ln.startswith("StoryCloze: ")]
    assert line(port_out) == line(jax_out) == [f"StoryCloze: {res['StoryCloze']}"]
    assert 0.0 <= res["StoryCloze"] <= 1.0


@pytest.mark.parametrize("prompt,cont,glob", [("TEXT", "SPEECH", "prompts/*.txt"),
                                              ("SPEECH", "TEXT", "cm/*_correct.wav")])
def test_eval_cli_cm_generate_matches_jax(eval_files, monkeypatch, prompt, cont, glob):
    """Greedy continuations in the forced modality: the same ids, and the
    modality mask holds (unit ids for SPEECH, text ids for TEXT)."""
    from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
    from slamkit_tpu.vocoder import checkpoint_manager as jax_ckpt
    from slamkit_tpu_torch.cli import eval as port_eval
    from slamkit_tpu_torch.models import UnitLM
    from slamkit_tpu_torch.vocoder import checkpoint_manager as port_ckpt

    for mgr in (port_ckpt.CHECKPOINT_MANAGER, jax_ckpt.CHECKPOINT_MANAGER):
        monkeypatch.setattr(mgr, "disk_root", (eval_files / "textless").resolve())

    def no_download(*args, **kwargs):
        raise AssertionError("the vocoder files must be local")

    monkeypatch.setattr(jax_ckpt.CHECKPOINT_MANAGER, "download_by_name", no_download)
    outs = {}
    ids = {"port": [], "jax": []}
    _recording(monkeypatch, UnitLM, "generate", ids["port"])
    _recording(monkeypatch, JaxUnitLM, "generate", ids["jax"])
    for name, run in (("port", port_eval.eval_main), ("jax", _jax_cli("eval").eval_main)):
        outs[name] = eval_files / f"gen_{name}_{cont}"
        res = run(_eval_overrides(
            eval_files, "metric=cm_generate", f"metric.data_path={eval_files / glob}",
            f"metric.prompt_modality={prompt}", f"metric.cont_modality={cont}",
            "metric.num_files=4", "metric.prompt_length=0.3", "metric.ext=wav",
            "metric.generate_kwargs.max_new_tokens=8", "metric.generate_kwargs.do_sample=false",
            f"metric.out_path={outs[name]}", "vocoder=vocoder_hubert_25"))
        if name == "port":
            port_res = res
    assert len(ids["port"]) == len(ids["jax"]) == 2                  # batches of 3 and 1
    for a, b in zip(ids["port"], ids["jax"]):
        np.testing.assert_array_equal(a, b)
    new = np.concatenate([a[:, -8:].ravel() for a in ids["port"]])
    units = (new >= N_ENTRIES) & (new < N_ENTRIES + 500)
    specials = np.isin(new, [0, 1, 2])                              # pad / bos / eos
    assert (units | specials).all() if cont == "SPEECH" else not units.any()
    files = sorted(p.name for p in outs["port"].iterdir())
    assert files == sorted(p.name for p in outs["jax"].iterdir()) and len(files) == 4
    for f in files:
        if f.endswith(".txt"):
            assert (outs["port"] / f).read_text() == (outs["jax"] / f).read_text()
        else:
            from slamkit_tpu_torch.utils.audio import load_audio

            np.testing.assert_allclose(load_audio(str(outs["port"] / f)),
                                       load_audio(str(outs["jax"] / f)), atol=1e-4)
    assert all(isinstance(g, str) for g in port_res["generate"]) == (cont == "TEXT")


# --------------------------------------------------------------------------- #
# the modality mask
# --------------------------------------------------------------------------- #
def test_bad_words_mask_equals_the_loop(work):
    """`UnitLM.generate`'s ban mask, built with one index operation, equals
    the per-id loop it replaced: at the 152167-id vocabulary on a seeded id
    list (unigram lists, bare ids, a longer sequence that bans nothing), and
    on the interleaving tokeniser's SPEECH and TEXT ignore lists."""
    from slamkit_tpu_torch.models.unit_lm import bad_words_mask
    from slamkit_tpu_torch.tokeniser import InterleavingTokeniser

    def loop(words, vocab):
        mask = torch.zeros(vocab, dtype=torch.bool)
        for ids in words:
            ids = ids if isinstance(ids, (list, tuple)) else [ids]
            if len(ids) == 1:
                mask[int(ids[0])] = True
        return mask

    rng = np.random.default_rng(0)
    vocab = sims_recipe.QWEN25_VOCAB + 502
    words = [[int(i)] for i in rng.choice(vocab, 20000, replace=False)]
    words += [int(rng.integers(vocab)), (int(rng.integers(vocab)),), [5, 6, 7]]
    assert torch.equal(bad_words_mask(words, vocab), loop(words, vocab))
    assert bad_words_mask(None, vocab) is None and bad_words_mask([], vocab) is None
    assert not bad_words_mask([[1, 2]], vocab).any()
    tok = InterleavingTokeniser(None, load_fe=False, text_tokeniser_path=str(work / "base"))
    for mod in ("SPEECH", "TEXT"):
        words = [[t] for t in tok.get_ignore_tokens(mod)]
        assert torch.equal(bad_words_mask(words, VOCAB), loop(words, VOCAB))
