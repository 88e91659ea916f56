"""The port's data-preparation and preference command lines against the JAX
package's `cli/` scripts, in process and in float32 on the CPU, on the repo's
`config/` tree:

  * `extract_features` (ext=wav) over a nested folder of seeded WAVs, with
    and without the file-list cache and data_skip / data_take, and with the
    YAML's default ext=flac over seeded FLAC files: the same lines (file,
    units, durations) in the same order;
  * `prepare_tokens` on one features.jsonl (a failing line included): a
    byte-identical tokens.jsonl;
  * `preference_alignment_feature_extractor` over WAV triples: the same rows;
  * `preference_alignment_train`: 2 DPO steps from one checkpoint (written by
    the JAX package's `save_pretrained`), losses, rewards and the eval loss
    within 1e-4 relative (float32 forward, backward and AdamW whose sums run
    in another order); the port resumed from checkpoint-1 repeats step 2 bit
    for bit. The JAX CLI runs on the suite's 8 virtual CPU devices, whose
    data axis multiplies the per-device batch: it gets a per-device batch of
    1 where the port (one device) gets 8, the same global batch;
  * the refusals: an interleave tokeniser, the unported training knobs.

Fixtures: a tiny random HuBERT written by `feature_extractor/hubert.py::
save_hf_dir`, and 500 k-means centroids drawn from its own features of the
WAVs (random centroids would give every frame one unit).
"""
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu_torch.cli import extract_features as port_extract
from slamkit_tpu_torch.cli import preference_alignment_feature_extractor as port_pref_fe
from slamkit_tpu_torch.cli import preference_alignment_train as port_dpo
from slamkit_tpu_torch.cli import prepare_tokens as port_prepare
from slamkit_tpu_torch.feature_extractor import HubertConfig
from slamkit_tpu_torch.feature_extractor.hubert import forward, random_params, save_hf_dir
from slamkit_tpu_torch.tools import data_recipe
from slamkit_tpu_torch.utils.audio import load_audio, save_wav
from slamkit_tpu_torch.utils.tree import to_torch

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_LM = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=502, twist_init=False,
               torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))
HUBERT = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                      hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                      intermediate_size=64, num_conv_pos_embeddings=8,
                      num_conv_pos_embedding_groups=4)


def _jax_cli(name: str):
    """The JAX package's cli/<name>.py as a module (cli/ is not a package)."""
    mod_name = f"_jax_cli_{name}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, REPO_ROOT / "cli" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def _tone(rng, seconds):
    t = np.arange(int(seconds * 16000)) / 16000
    f0 = rng.uniform(100, 300) * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
    return 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) + 0.05 * rng.standard_normal(t.size)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Seven seeded WAVs of distinct lengths in nested folders (and a FLAC-
    named file the glob must skip), the HuBERT directory, the centroids, and
    four preference triples over the WAVs."""
    d = tmp_path_factory.mktemp("prep")
    rng = np.random.default_rng(0)
    wavs = []
    for i, seconds in enumerate(rng.permutation(np.linspace(0.25, 0.6, 7))):
        folder = d / "wavs" / f"spk{i % 3}" / ("ch" if i % 2 else "")
        folder.mkdir(parents=True, exist_ok=True)
        save_wav(str(folder / f"u{i}.wav"), _tone(rng, seconds))
        wavs.append(folder / f"u{i}.wav")
    (d / "wavs" / "skip.flac").write_bytes(b"not audio")
    params = random_params(HUBERT, seed=1)
    save_hf_dir(str(d / "hubert"), params, HUBERT)
    tp = to_torch(params, torch.device("cpu"))
    frames = np.concatenate([forward(tp, HUBERT, torch.from_numpy(load_audio(str(p)))[None],
                                     tap_layer=2)[0].numpy() for p in wavs])
    np.save(d / "km.npy", frames[rng.choice(len(frames), 500)].astype(np.float32))
    with open(d / "triples.jsonl", "w") as f:
        for i in range(4):
            p, c, r = (str(wavs[(i + k) % 7]) for k in range(3))
            f.write(json.dumps({"prompt_path": p, "chosen_path": c, "rejected_path": r,
                                "prompt_text": f"t{i}"}) + "\n")
    return d


def _fe_overrides(files, *extra):
    return [f"tokeniser.feature_extractor.pretrained_model={files / 'hubert'}",
            f"tokeniser.feature_extractor.kmeans_path={files / 'km.npy'}",
            "tokeniser.feature_extractor.layer=2", "device=cpu", *extra]


def _lines(path):
    return [json.loads(line) for line in pathlib.Path(path).read_text().splitlines()]


@pytest.mark.parametrize("extra", [[], ["data_skip=1", "data_take=4", "cache_path={d}/cache"]])
def test_extract_features_equals_jax(files, tmp_path, extra):
    extra = [e.format(d=tmp_path) for e in extra]
    common = [f"data_path={files / 'wavs'}", "ext=wav", "batch_size=3", "num_workers=2", *extra]
    n = port_extract.extract_features(_fe_overrides(
        files, *common, f"out_path={tmp_path / 'port.jsonl'}"))
    _jax_cli("extract_features").extract_features(_fe_overrides(
        files, *common, f"out_path={tmp_path / 'jax.jsonl'}"))
    got, want = _lines(tmp_path / "port.jsonl"), _lines(tmp_path / "jax.jsonl")
    assert n == len(got) == len(want) == (4 if extra else 7)
    assert [r["file_name"] for r in got] == [r["file_name"] for r in want]
    for a, b in zip(got, want):
        assert a == b, a["file_name"]
    assert len({u for r in got for u in r["units"]}) > 5      # the frames differ
    if extra:   # the cached file list is read back on a second run
        assert (tmp_path / "cache" / "data" / "wavs.pkl").is_file()
        port_extract.extract_features(_fe_overrides(
            files, *common, f"out_path={tmp_path / 'again.jsonl'}"))
        assert _lines(tmp_path / "again.jsonl") == got


def test_extract_features_reads_wav_only(files, tmp_path):
    """Now FLAC as well: with the YAML's default ext=flac, over seeded FLAC
    files (16 and 24 bits, 16 kHz mono and 44.1 kHz stereo, nested), the
    port writes the JAX CLI's lines; the WAVs beside them are skipped."""
    flacs = tmp_path / "flacs"
    kinds = ((16000, 1, 16), (44100, 2, 16), (16000, 1, 24), (44100, 1, 24))
    for i, (flac, *_) in enumerate(data_recipe.write_audio_set(
            flacs, 6, seconds=(0.25, 0.6), seed=5, kinds=kinds)):
        if i % 2:
            (flacs / f"d{i}").mkdir()
            flac.rename(flacs / f"d{i}" / flac.name)
    common = [f"data_path={flacs}", "batch_size=2", "num_workers=2"]
    n = port_extract.extract_features(_fe_overrides(
        files, *common, f"out_path={tmp_path / 'port.jsonl'}"))
    _jax_cli("extract_features").extract_features(_fe_overrides(
        files, *common, f"out_path={tmp_path / 'jax.jsonl'}"))
    got, want = _lines(tmp_path / "port.jsonl"), _lines(tmp_path / "jax.jsonl")
    assert n == len(got) == len(want) == 6
    assert got == want
    assert all(r["file_name"].endswith(".flac") for r in got)


def test_prepare_tokens_byte_identical_to_jax(files, tmp_path):
    rng = np.random.default_rng(4)
    with open(tmp_path / "features.jsonl", "w") as f:
        for i in range(12):
            units = rng.integers(0, 500, int(rng.integers(1, 40))).tolist()
            f.write(json.dumps({"units": units, "duration": [1] * len(units),
                                "file_name": f"/a/b/u{i}.wav"}) + "\n")
            if i == 5:
                f.write('{"units": [1, 2], "file_name"\n')     # a failing line: skipped
    common = [f"data_path={tmp_path / 'features.jsonl'}", "+device=cpu", "n_threads=3"]
    n = port_prepare.prepare_tokens([*common, f"out_path={tmp_path / 'port.jsonl'}"])
    _jax_cli("prepare_tokens").prepare_tokens([*common, f"out_path={tmp_path / 'jax.jsonl'}"])
    got, want = (tmp_path / "port.jsonl").read_bytes(), (tmp_path / "jax.jsonl").read_bytes()
    assert n == 12 and got == want
    assert list(json.loads(got.splitlines()[0])) == ["file_name", "audio_repr"]


def test_preference_feature_extractor_equals_jax(files, tmp_path):
    common = [f"data_path={files / 'triples.jsonl'}", "batch_size=3", "skip=1"]
    n = port_pref_fe.extract_features(_fe_overrides(
        files, *common, f"out_path={tmp_path / 'port.jsonl'}"))
    _jax_cli("preference_alignment_feature_extractor").extract_features(_fe_overrides(
        files, *common, f"out_path={tmp_path / 'jax.jsonl'}"))
    got, want = _lines(tmp_path / "port.jsonl"), _lines(tmp_path / "jax.jsonl")
    assert n == len(got) == len(want) == 3
    assert got == want
    assert all(set(r[k]) == {"units", "duration"} for r in got
               for k in ("prompt", "chosen", "rejected"))


def _write_preferences(path, n, seed):
    """Rows as the preference extractor writes them, with texts of distinct
    words so that the default repetition filter keeps every row."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            row = {k: {"units": (u := rng.integers(0, 500, int(rng.integers(lo, hi))).tolist()),
                       "duration": [1] * len(u)}
                   for k, (lo, hi) in (("prompt", (10, 30)), ("chosen", (5, 15)),
                                       ("rejected", (5, 15)))}
            words = rng.choice(10000, 12, replace=False)
            row.update(prompt_text=" ".join(f"w{x}" for x in words[:6]),
                       chosen_text=" ".join(f"w{x}" for x in words[6:]))
            f.write(json.dumps(row) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def dpo_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dpo")
    JaxUnitLM(JaxUnitLMConfig(**TINY_LM), seed=0).save_pretrained(str(d / "ckpt"))
    _write_preferences(d / "train.jsonl", 24, seed=0)
    _write_preferences(d / "val.jsonl", 5, seed=1)
    return d


def _dpo_overrides(d, out, per_device, **extra):
    ov = {"model.pretrained_model": d / "ckpt", "model.config_args.torch_dtype": "float32",
          "data.train_path": d / "train.jsonl", "data.val_path": d / "val.jsonl",
          "training_args.output_dir": out, "training_args.max_steps": 2,
          "training_args.per_device_train_batch_size": per_device,
          "training_args.logging_steps": 1, "training_args.save_steps": 1,
          "training_args.warmup_steps": 0, "training_args.warmup_ratio": 0.0,
          "training_args.learning_rate": 1e-3, **extra}
    return [f"{k}={v}" for k, v in ov.items()]


def _history(out, step):
    return json.loads((pathlib.Path(out) / f"checkpoint-{step}" /
                       "trainer_state.json").read_text())["log_history"]


def test_preference_train_equals_jax_and_resumes(dpo_files):
    d = dpo_files
    state = port_dpo.train(_dpo_overrides(d, d / "port", 8,
                                          **{"training_args.use_cpu": "true"}))
    _jax_cli("preference_alignment_train").train(_dpo_overrides(d, d / "jax", 1))
    got, want = _history(d / "port", 2), _history(d / "jax", 2)
    pick = lambda h, key: [r[key] for r in h if key in r]
    assert state.global_step == 2 and len(pick(got, "loss")) == 2
    assert pick(got, "loss")[0] == pytest.approx(np.log(2), abs=1e-6)
    assert abs(pick(got, "loss")[1] - np.log(2)) > 1e-4     # the policy moved
    for key in ("loss", "rewards/chosen", "rewards/rejected", "rewards/margins",
                "learning_rate", "eval_loss"):
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-4, atol=1e-7,
                                   err_msg=key)
    assert pick(got, "rewards/accuracies") == pick(want, "rewards/accuracies")
    resumed = port_dpo.train(_dpo_overrides(
        d, d / "resumed", 8, **{"training_args.use_cpu": "true",
                                "cont_training": d / "port" / "checkpoint-1"}))
    assert resumed.global_step == 2
    assert pick(_history(d / "resumed", 2), "loss")[-1] == pick(got, "loss")[-1]


@pytest.mark.parametrize("overrides,error,match", [
    (["tokeniser=interleaved_hubert_25"], ValueError, "Interleave tokeniser"),
    # fsdp and multihost are ported (tests/test_torch_fsdp*.py,
    # tests/test_torch_multihost.py); multihost without torchrun raises
    pytest.param(["training_args.fsdp=true", "training_args.multihost=true"],
                 RuntimeError, "torch.distributed.run --nnodes N",
                 id="overrides1-NotImplementedError-item 14"),
    pytest.param(["training_args.multihost=true"], RuntimeError,
                 "torch.distributed.run --nnodes N", id="overrides2-NotImplementedError-item 14"),
    # attention dropout on the flash path raises, as in JAX (the id is the
    # case's name from when any dropout was refused)
    pytest.param(["model.pretrained_model=null", "model.config_args.attention_dropout=0.1",
                  "model.config_args.attn_implementation=flash_attention_2"], ValueError,
                 "attention_dropout", id="overrides3-ValueError-item 6"),
])
def test_preference_train_refuses_what_is_not_ported(dpo_files, tmp_path, overrides, error,
                                                     match):
    with pytest.raises(error, match=match):
        port_dpo.train(_dpo_overrides(dpo_files, tmp_path, 8,
                                      **{"training_args.use_cpu": "true"}) + overrides)
