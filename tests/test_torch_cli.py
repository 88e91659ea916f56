"""The port's command-line entry points (`slamkit_tpu_torch.cli.train` and
`.eval`) against the JAX package's `cli/train.py` and `cli/eval.py`, in
process and in float32 on the CPU, on the repo's `config/` tree.

  * train: both CLIs fine-tune one checkpoint (written by the JAX package's
    `save_pretrained`) for 3 steps of best-fit-packed batches with remat,
    accumulation 2 and a save every step; their logged losses, learning
    rates and eval loss agree, and the port resumed from checkpoint-2 with
    `cont_training` repeats the uninterrupted step 3. The JAX CLI runs on
    the suite's 8 virtual CPU devices, whose data axis multiplies the
    per-device batch: it gets a per-device batch of 1 where the port (one
    device) gets 8, so both train on the same global batch of 8 rows.
  * eval: both CLIs score a fabricated sBLIMP layout of seeded WAVs through
    a tiny random HuBERT written here and k-means centroids drawn from its
    own features, with and without `metric.joint_pairs`: every
    log-likelihood call agrees and the printed scores are equal; the
    generate branch continues the same prompts to the same greedy units.
  * the rules and refusals the CLIs add on the way, and `data.saved_ds_path`:
    a cached run repeats the run that wrote the cache bit for bit.

Tolerances: losses and the eval loss 1e-4 relative (float32 forward,
backward and AdamW whose sums run in another order), learning rates 1e-6;
the resumed step-3 loss 1e-6 relative (same ops, same order on the CPU);
log-likelihoods 1e-4 absolute (mean NLL of a float32 two-layer forward).
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
from slamkit_tpu_torch.cli import eval as port_eval
from slamkit_tpu_torch.cli import train as port_train

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY_LM = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=502, twist_init=False,
               torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))


def _jax_cli(name: str):
    """The JAX package's cli/<name>.py as a module (cli/ is not a package)."""
    mod_name = f"_jax_cli_{name}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, REPO_ROOT / "cli" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def _write_tokens(path, n, seed):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for i in range(n):
            units = rng.integers(0, 500, int(rng.integers(8, 60)))
            f.write(json.dumps({"file_name": f"r{i}",
                                "audio_repr": "".join(f"<Un{u}>" for u in units)}) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """A JAX-written checkpoint, a seeded corpus and validation set."""
    d = tmp_path_factory.mktemp("cli")
    JaxUnitLM(JaxUnitLMConfig(**TINY_LM), seed=0).save_pretrained(str(d / "ckpt"))
    _write_tokens(d / "train.jsonl", 96, seed=0)
    _write_tokens(d / "val.jsonl", 12, seed=1)
    return d


def _train_overrides(work, out, per_device, **extra):
    ov = {"model.pretrained_model": work / "ckpt", "model.context_len": 64,
          "model.config_args.torch_dtype": "float32",
          "data.train_path": work / "train.jsonl", "data.val_path": work / "val.jsonl",
          "data.packing": "true", "training_args.output_dir": out,
          "training_args.max_steps": 3, "training_args.gradient_accumulation_steps": 2,
          "training_args.per_device_train_batch_size": per_device,
          "training_args.per_device_eval_batch_size": per_device,
          "training_args.logging_steps": 1, "training_args.save_steps": 1,
          "training_args.eval_steps": 3, "training_args.warmup_steps": 1,
          "training_args.remat": "true", **extra}
    return [f"{k}={v}" for k, v in ov.items()]


def _history(out, step):
    return json.loads((pathlib.Path(out) / f"checkpoint-{step}" /
                       "trainer_state.json").read_text())["log_history"]


def _pick(history, key):
    return [r[key] for r in history if key in r]


def test_train_cli_matches_jax_and_resumes(work):
    port_state = port_train.train(_train_overrides(work, work / "port", 8,
                                                   **{"training_args.use_cpu": "true"}))
    _jax_cli("train").train(_train_overrides(work, work / "jax", 1))
    got, want = _history(work / "port", 3), _history(work / "jax", 3)
    assert port_state.global_step == 3 and len(_pick(got, "loss")) == 3
    np.testing.assert_allclose(_pick(got, "loss"), _pick(want, "loss"), rtol=1e-4)
    np.testing.assert_allclose(_pick(got, "eval_loss"), _pick(want, "eval_loss"), rtol=1e-4)
    np.testing.assert_allclose(_pick(got, "learning_rate"), _pick(want, "learning_rate"),
                               rtol=1e-6)
    assert _pick(got, "num_input_tokens_seen") == _pick(want, "num_input_tokens_seen")
    # the fine-tune kept remat on: training_args.remat reached the decoder
    saved = json.loads((work / "port" / "checkpoint-3" / "unit_lm_config.json").read_text())
    assert saved["remat"] is True

    resumed = port_train.train(_train_overrides(
        work, work / "resumed", 8, **{"training_args.use_cpu": "true",
                                      "cont_training": work / "port" / "checkpoint-2"}))
    assert resumed.global_step == 3
    np.testing.assert_allclose(_pick(_history(work / "resumed", 3), "loss")[-1],
                               _pick(got, "loss")[-1], rtol=1e-6)


def _cached_runs_match(work, tmp_path, mixed):
    """data.saved_ds_path (one corpus or a mixed list): a first run builds
    the dataset (spilled past 500 tokens) and writes the cache, a second
    loads it, and both take the same steps bit for bit; the cache holds the
    JAX package's rows and loads in the JAX package."""
    from slamkit_tpu.data import dataset as jax_dataset
    from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser

    train = (f"[{work / 'train.jsonl'},{work / 'val.jsonl'}]" if mixed
             else work / "train.jsonl")
    data = {"data.train_path": train, "data.saved_ds_path": tmp_path / "cache",
            "data.spill_tokens": 500, "data.spill_dir": tmp_path / "spill",
            **({"data.train_ratios": "[0.7,0.3]"} if mixed else {})}
    runs = []
    for run in ("first", "cached"):
        port_train.train(_train_overrides(work, tmp_path / run, 8, **{
            "training_args.use_cpu": "true", "training_args.max_steps": 2,
            "training_args.save_steps": 2, "training_args.eval_steps": 2, **data}))
        runs.append(_history(tmp_path / run, 2))
        assert sorted(p.name for p in (tmp_path / "cache").iterdir()) == ["train", "validation"]
    assert _pick(runs[0], "loss") == _pick(runs[1], "loss") and len(_pick(runs[0], "loss")) == 2
    assert _pick(runs[0], "eval_loss") == _pick(runs[1], "eval_loss")
    assert not list((tmp_path / "spill").iterdir())
    node = type("Node", (dict,), {"__getattr__": dict.__getitem__})
    jdata = node({"train_path": [str(work / "train.jsonl"), str(work / "val.jsonl")]
                  if mixed else str(work / "train.jsonl"), "val_path": str(work / "val.jsonl"),
                  "train_ratios": [0.7, 0.3]})
    want = jax_dataset.init_dataset(node(data=jdata, model=node(context_len=64)),
                                    JaxUnitTokeniser(load_fe=False))
    for split in ("train", "validation"):
        got = jax_dataset.TokenDataset.load(str(tmp_path / "cache" / split))
        assert len(got) == len(want[split]) > 0
        for i in range(len(got)):
            np.testing.assert_array_equal(got[i], want[split][i])


@pytest.mark.parametrize("overrides,match", [
    (["training_args.multihost=true"], "torch.distributed.run --nnodes N"),
    (["data.train_path=[/a.jsonl,/b.jsonl]", "data.saved_ds_path=/tmp/ds"], None),
    (["data.saved_ds_path=/tmp/ds"], None),
    # fsdp and multihost are ported (tests/test_torch_fsdp*.py,
    # tests/test_torch_multihost.py); multihost without torchrun raises
    (["training_args.fsdp=true", "training_args.multihost=true"],
     "torch.distributed.run --nnodes N"),
], ids=["overrides0-item 14", "overrides1-item 18", "overrides2-item 18", "overrides3-item 14"])
def test_train_cli_refuses_what_is_not_ported(work, tmp_path, overrides, match):
    """multihost=true without torchrun raises, naming the launch over
    several nodes, as `jax.distributed.initialize()` raises without a
    cluster; data.saved_ds_path (match None), ported since, caches the
    dataset instead: see _cached_runs_match."""
    if match is None:
        _cached_runs_match(work, tmp_path, mixed=overrides[0].startswith("data.train_path=["))
        return
    base = [f"data.train_path={work / 'train.jsonl'}", f"data.val_path={work / 'val.jsonl'}",
            f"training_args.output_dir={tmp_path}", "training_args.use_cpu=true"]
    with pytest.raises(RuntimeError, match=match):
        port_train.train(base + overrides)


def test_train_cli_takes_the_paper_config_with_twist(work, tmp_path, monkeypatch, caplog):
    """model=slam as the paper gives it (twist_init: true), cut to two
    layers: the TWIST warm start warns that Qwen's weights do not fit (and
    none are on this machine) and starts from random init, and the run
    trains; vocab_size -1 becomes the unit tokeniser's 502; the epoch budget
    follows train_max_tokens / ds_token_size and the token stopper ends the
    run once 400 tokens are seen."""
    import logging

    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty_hub"))
    with caplog.at_level(logging.INFO):
        state = port_train.train([
            "model=slam", "model.context_len=64", "model.config_args.torch_dtype=float32",
            "+model.config_args.num_hidden_layers=2", f"data.train_path={work / 'train.jsonl'}",
            f"data.val_path={work / 'val.jsonl'}", f"training_args.output_dir={tmp_path / 'o'}",
            "training_args.use_cpu=true", "training_args.per_device_train_batch_size=4",
            "training_args.logging_steps=1", "training_args.max_steps=-1",
            "train_max_tokens=400", "+ds_token_size=1000"])
    assert any("TWIST init requested" in r.getMessage() for r in caplog.records)
    assert any("num_train_epochs" in r.getMessage() for r in caplog.records)
    saved = json.loads((tmp_path / "o" / f"checkpoint-{state.global_step}" /
                        "unit_lm_config.json").read_text())
    assert saved["vocab_size"] == 502 and saved["twist_init"] is True
    assert 400 <= state.num_input_tokens_seen and state.global_step < state.max_steps


def test_unit_vocab_size_equals_jax():
    """`vocab_size: -1` reads len(tokeniser.text_tokeniser): 502 for
    unit_hubert_25, as the JAX tokeniser answers."""
    from slamkit_tpu.config import compose as jax_compose
    from slamkit_tpu.tokeniser import tokeniser_factory as jax_factory
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.tokeniser import tokeniser_factory

    cfg = compose(str(REPO_ROOT / "config"), "train")
    port = tokeniser_factory(cfg.tokeniser, device="cpu")
    ref = jax_factory(jax_compose(str(REPO_ROOT / "config"), "train").tokeniser)
    assert len(port.text_tokeniser) == len(ref.text_tokeniser) == 502
    for key in ("pad_token_id", "bos_token_id", "eos_token_id"):
        assert getattr(port.text_tokeniser, key) == getattr(ref.text_tokeniser, key)


def test_init_dataset_equals_jax(work):
    from slamkit_tpu.config import compose as jax_compose
    from slamkit_tpu.data.dataset import init_dataset as jax_init_dataset
    from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.data import init_dataset
    from slamkit_tpu_torch.tokeniser import UnitTokeniser

    ov = [f"data.train_path={work / 'train.jsonl'}", f"data.val_path={work / 'val.jsonl'}",
          "model.context_len=32", "data.chunk_units_min_length=5",
          "data.sample_units_max_length=55"]
    got = init_dataset(compose(str(REPO_ROOT / "config"), "train", ov), UnitTokeniser())
    want = jax_init_dataset(jax_compose(str(REPO_ROOT / "config"), "train", ov),
                            JaxUnitTokeniser(load_fe=False))
    assert sorted(got) == sorted(want) == ["train", "validation"]
    for split in got:
        assert len(got[split]) == len(want[split])
        for i in range(len(got[split])):
            np.testing.assert_array_equal(got[split][i], np.asarray(want[split][i]))


# --------------------------------------------------------------------------- #
# eval
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def eval_files(work):
    """Eight seeded sBLIMP pairs (gliding tones in noise, 0.3-0.7 s), a tiny
    random HuBERT saved by transformers, and 500 centroids drawn from its
    own features of those WAVs (random centroids would give every frame one
    unit)."""
    transformers = pytest.importorskip("transformers")
    from slamkit_tpu_torch.feature_extractor.hubert import forward, load_hf_dir
    from slamkit_tpu_torch.utils.audio import load_audio, save_wav
    from slamkit_tpu_torch.utils.tree import to_torch

    rng = np.random.default_rng(3)
    pairs = work / "sblimp"
    pairs.mkdir()
    for i in range(16):
        t = np.arange(int(rng.integers(4800, 11200))) / 16000
        f0 = rng.uniform(100, 300) * (1 + 0.3 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t))
        wav = 0.3 * np.sin(2 * np.pi * np.cumsum(f0) / 16000) + 0.05 * rng.standard_normal(t.size)
        save_wav(str(pairs / f"{i}+{'p' if i % 2 == 0 else 'n'}.wav"), wav)
    torch.manual_seed(0)
    hubert = transformers.HubertModel(transformers.HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        conv_dim=(32, 32, 32), conv_kernel=(10, 3, 3), conv_stride=(5, 4, 4),
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4))
    hubert.save_pretrained(work / "hubert")
    params, cfg = load_hf_dir(str(work / "hubert"))
    params = to_torch(params, torch.device("cpu"))
    frames = np.concatenate([
        forward(params, cfg, torch.from_numpy(load_audio(str(p)))[None], tap_layer=2)[0].numpy()
        for p in sorted(pairs.glob("*.wav"))])
    centroids = frames[rng.choice(len(frames), 500, replace=len(frames) < 500)]
    np.save(work / "km.npy", centroids.astype(np.float32))
    return work


def _eval_overrides(files, *extra):
    return [f"model.pretrained_model={files / 'ckpt'}", "model.config_args.torch_dtype=float32",
            f"tokeniser.feature_extractor.pretrained_model={files / 'hubert'}",
            f"tokeniser.feature_extractor.kmeans_path={files / 'km.npy'}",
            "tokeniser.feature_extractor.layer=2", "batch_size=3", "num_workers=2",
            "device=cpu", *extra]


def _recording(monkeypatch, cls, record):
    original = cls.log_likelihood

    def wrapped(self, *args, **kwargs):
        ll = original(self, *args, **kwargs)
        record.append(np.asarray(ll.numpy() if isinstance(ll, torch.Tensor) else ll))
        return ll

    monkeypatch.setattr(cls, "log_likelihood", wrapped)


@pytest.mark.parametrize("joint_pairs", [False, True])
def test_eval_cli_scores_like_jax(eval_files, monkeypatch, capsys, joint_pairs):
    from slamkit_tpu.models.speech_lm import SpeechLM as JaxSpeechLM
    from slamkit_tpu_torch.models.speech_lm import SpeechLM

    ov = _eval_overrides(eval_files, "metric=sblimp", f"metric.data_path={eval_files / 'sblimp'}",
                         "metric.subfolder=false", f"+metric.joint_pairs={joint_pairs}")
    got, want = [], []
    _recording(monkeypatch, SpeechLM, got)
    _recording(monkeypatch, JaxSpeechLM, want)
    capsys.readouterr()
    res = port_eval.eval_main(ov)
    port_out = capsys.readouterr().out
    _jax_cli("eval").eval_main(ov)
    jax_out = capsys.readouterr().out
    assert len(got) == len(want) == (3 if joint_pairs else 6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-4)
    line = lambda out: [ln for ln in out.splitlines() if ln.startswith("sBLIMP: ")]
    assert line(port_out) == line(jax_out) == [f"sBLIMP: {res['sBLIMP']}"]
    assert len(np.unique(np.concatenate(got))) > 4     # the pairs score apart


def test_eval_cli_generate_branch_matches_jax(eval_files, monkeypatch):
    """metric=generate (no vocoder: units only), greedy: the same units."""
    from slamkit_tpu.metric import generative_metric as jax_generative

    ov = _eval_overrides(eval_files, "metric=generate",
                         f"metric.data_path={eval_files / 'sblimp'}/*+p.wav",
                         "metric.generate_kwargs.max_new_tokens=6",
                         "metric.generate_kwargs.do_sample=false", "metric.prompt_length=0.2",
                         f"metric.out_path={eval_files / 'gen'}")
    res = port_eval.eval_main(ov)
    captured = {}
    original = jax_generative.generate

    def capture(*args, **kwargs):
        captured["res"] = original(*args, **kwargs)
        return captured["res"]

    monkeypatch.setattr(jax_generative, "generate", capture)
    _jax_cli("eval").eval_main(ov)
    assert len(res["generate"]) == len(captured["res"]["generate"]) == 5
    for a, b in zip(res["generate"], captured["res"]["generate"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# eval_mesh and its parameter sharding, eval_fsdp, are ported
# (tests/test_torch_eval_mesh.py, tests/test_torch_fsdp_jax.py); a backend
# of another package raises for either metric
@pytest.mark.parametrize("extra,match", [
    (["metric=asr_perplexity", "+metric.asr_backend=onnx"], "asr_backend='onnx'"),
    (["metric=llm_as_judge", "+metric.llm_backend=vllm"], "llm_backend='vllm'"),
    (["metric=llm_as_judge", "+metric.asr_backend=whisperx"], "asr_backend='whisperx'"),
], ids=["extra0-asr_backend='onnx'", "extra1-llm_backend='vllm'", "extra2-item 14"])
def test_eval_cli_refuses_what_is_not_ported(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        port_eval.eval_main(["device=cpu", *extra])


def test_eval_cli_refuses_several_ranks(monkeypatch):
    """Under torchrun's WORLD_SIZE > 1 without eval_mesh, and with an
    eval_mesh of another size, the eval raises rather than evaluating a copy
    on every rank; eval_mesh on one process raises too."""
    monkeypatch.setenv("WORLD_SIZE", "4")
    for mesh in ([], ["eval_mesh=2"]):
        with pytest.raises(ValueError, match="WORLD_SIZE=4"):
            port_eval.eval_main(["device=cpu", "metric=sblimp", *mesh])
    monkeypatch.setenv("WORLD_SIZE", "1")
    with pytest.raises(ValueError, match="--nproc_per_node 2.*WORLD_SIZE=1"):
        port_eval.eval_main(["device=cpu", "metric=sblimp", "eval_mesh=2"])
