"""The port stands without JAX, PyYAML, transformers, tokenizers,
safetensors, nltk and openai (the card's host has none of them): serving, training two steps
with a save, speech continuation dense and int8, the benchmark tools, and the
command line (composing train.yaml with model=slam, two training steps through
`cli.train`, one sBLIMP pair through `cli.eval`, then `cli.extract_features`,
`cli.prepare_tokens`, the preference extractor and two DPO steps through
`cli.preference_alignment_train`); the SIMS path (the smoke's phases 9-11 at
tiny widths: the tokenizer.json reader, interleaved stage 2, `cli.train
--config-name train_inter_scale`, cm_ms_tsc and cm_generate); GenPPL and the
LLM judge (the smoke's phases 9 and 12 at tiny widths: `cli.eval
metric=asr_perplexity` and `metric=llm_as_judge` through the port's Whisper
and text LM); and
`chip_smoke.py` refuses to run without a card: no CPU fallback can pass for a
GPU run."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCKER = r"""
import importlib.abc, json, os, sys, tempfile

BLOCKED = ("jax", "slamkit_tpu", "yaml", "transformers", "tokenizers", "safetensors", "nltk",
           "openai")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked: the port must run without it")
        return None


sys.meta_path.insert(0, Blocker())
"""

_NO_JAX = _BLOCKER + r"""
import torch
import slamkit_tpu_torch
import slamkit_tpu_torch.ops
from slamkit_tpu_torch.data import load_token_dataset
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig
from slamkit_tpu_torch.tokeniser import UnitTokeniser
from slamkit_tpu_torch.trainer import SLAMTrainer

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)
lm = UnitLM(UnitLMConfig(base_model_name="EleutherAI/pythia-14m", vocab_size=502,
                         twist_init=False, torch_dtype="float32", remat=True), device="cpu")
ll = lm.log_likelihood([[1, 5, 6, 7, 1, 0]])
out = lm.generate([[1, 5, 6]], max_new_tokens=3, seed=0)
assert torch.isfinite(ll).all() and out.shape == (1, 6)
with tempfile.TemporaryDirectory() as d:
    with open(os.path.join(d, "tokens.jsonl"), "w") as f:
        for i in range(24):
            units = "".join(f"<Un{(7 * i + j) % 500}>" for j in range(5 + i))
            f.write(json.dumps({"file_name": str(i), "audio_repr": units}) + "\n")
    ds = load_token_dataset(os.path.join(d, "tokens.jsonl"), UnitTokeniser())
    args = {"output_dir": os.path.join(d, "out"), "per_device_train_batch_size": 2,
            "gradient_accumulation_steps": 2, "max_steps": 2, "learning_rate": 1e-3,
            "lr_scheduler_type": "cosine_with_min_lr", "lr_scheduler_kwargs": {"min_lr": 5e-5},
            "max_grad_norm": 0.5, "optim_state_dtype": "bfloat16", "save_steps": 2,
            "logging_steps": 1}
    state = SLAMTrainer(lm, args, ds, packing=True, context_len=64).train()
    assert state.global_step == 2, state
    assert os.path.isfile(os.path.join(d, "out", "checkpoint-2", "trainer_state.json"))
    assert os.path.isfile(os.path.join(d, "out", "checkpoint-2", "state", "train_state.pt"))
    UnitLM.from_pretrained(os.path.join(d, "out", "checkpoint-2"), device="cpu")

# the speech path: WAV prompts -> HuBERT + k-means -> int8 and dense decoding
# -> CodeHiFiGAN, at tiny widths with seeded random weights
import numpy as np
from slamkit_tpu_torch.feature_extractor import HubertConfig, HubertFeatureExtractor
from slamkit_tpu_torch.feature_extractor.hubert import random_params
from slamkit_tpu_torch.metric import generative_metric
from slamkit_tpu_torch.models import SpeechLM
from slamkit_tpu_torch.tools import bench_decode, bench_flash, bench_prefill
from slamkit_tpu_torch.utils.audio import save_wav
from slamkit_tpu_torch.vocoder import HiFiGANVocoder, hifigan

hcfg = HubertConfig(conv_dim=(16, 16), conv_kernel=(10, 3), conv_stride=(5, 2),
                    hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=32, num_conv_pos_embeddings=4,
                    num_conv_pos_embedding_groups=2)
vcfg = {"model_in_dim": 8, "num_embeddings": 500, "embedding_dim": 8,
        "upsample_initial_channel": 8, "upsample_rates": [2], "upsample_kernel_sizes": [4],
        "resblock_kernel_sizes": [3], "resblock_dilation_sizes": [[1]],
        "dur_predictor_params": {"encoder_embed_dim": 8, "var_pred_hidden_dim": 8,
                                 "var_pred_kernel_size": 3}}
centroids = np.random.default_rng(0).standard_normal((500, 16)).astype(np.float32)
fe = HubertFeatureExtractor.from_params(random_params(hcfg), hcfg, centroids, layer=1,
                                        device="cpu")
voc = HiFiGANVocoder.from_params(
    hifigan.convert_torch_generator(hifigan.random_state_dict(vcfg), vcfg), vcfg, device="cpu")
speech = SpeechLM(lm, UnitTokeniser(fe), voc)
with tempfile.TemporaryDirectory() as d:
    for i in range(2):
        save_wav(os.path.join(d, f"{i}.wav"), 0.1 * np.sin(np.arange(1600 + 400 * i) / 9.0))
    for quant in ("int8", None):
        res = generative_metric.generate(speech, os.path.join(d, "*.wav"), batch_size=2,
                                         num_workers=2, max_new_tokens=3, seed=0,
                                         weight_quant=quant)
        assert len(res["generate"]) == 2 and all(w.size > 0 for w in res["generate"])
probe = bench_flash.probe(torch.device("cpu"), shapes=((64, 32, 64),), reps=2, iters=1)
assert probe["shapes"][0]["ms"] > 0
assert bench_flash.bench_shape(torch.device("cpu"), b=1, h=2, t=32, d=16, segs=2,
                               iters=1)["fwd_bwd_ms"] > 0
dec = bench_decode.run(lm, batch=2, prompt=4, new=3, iters=1)
assert dec["int8_dq_launches_per_call"] == 0 and dec["speedup"] > 0
assert bench_decode.main([]) == 1 and bench_flash.main(["--matmul-probe"]) == 1  # no card
assert bench_prefill.main([]) == 1

# the command line: the repo's config/ tree without PyYAML, cli.train on the
# paper's model=slam (cut to two narrow layers) and cli.eval on one pair
from slamkit_tpu_torch.cli import eval as cli_eval
from slamkit_tpu_torch.cli import train as cli_train
from slamkit_tpu_torch.config import compose
from slamkit_tpu_torch.feature_extractor.hubert import save_hf_dir

cfg = compose("config", "train", ["model=slam"])
assert cfg.model.config_args.twist_init is True and cfg.model.context_len == 1024
assert cfg.training_args.learning_rate == 1e-3
narrow = [f"+model.config_args.{k}={v}" for k, v in dict(
    num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=128).items()]
with tempfile.TemporaryDirectory() as d:
    corpus = os.path.join(d, "tokens.jsonl")
    with open(corpus, "w") as f:
        for i in range(24):
            units = "".join(f"<Un{(7 * i + j) % 500}>" for j in range(5 + i))
            f.write(json.dumps({"file_name": str(i), "audio_repr": units}) + "\n")
    state = cli_train.train(["model=slam", "model.context_len=64",
                             "model.config_args.torch_dtype=float32", *narrow,
                             f"data.train_path={corpus}", f"data.val_path={corpus}",
                             "data.packing=true", f"training_args.output_dir={d}/run",
                             "training_args.max_steps=2", "training_args.use_cpu=true",
                             "training_args.per_device_train_batch_size=2",
                             "training_args.remat=true", "training_args.save_steps=2"])
    assert state.global_step == 2, state
    save_hf_dir(os.path.join(d, "hubert"), random_params(hcfg), hcfg)
    np.save(os.path.join(d, "km.npy"), centroids)
    os.makedirs(os.path.join(d, "pair"))
    for i in range(2):
        save_wav(os.path.join(d, "pair", f"{i}+x.wav"), 0.1 * np.sin(np.arange(1600 + 400 * i) / 7.0))
    res = cli_eval.eval_main([f"model.pretrained_model={d}/run/checkpoint-2", "metric=sblimp",
                              f"metric.data_path={d}/pair", "metric.subfolder=false",
                              f"tokeniser.feature_extractor.pretrained_model={d}/hubert",
                              f"tokeniser.feature_extractor.kmeans_path={d}/km.npy",
                              "tokeniser.feature_extractor.layer=1", "device=cpu",
                              "num_workers=1"])
    assert res["sBLIMP"] in (0.0, 0.5, 1.0), res

    # data preparation and DPO: stage 1 and 2 over the pair, the preference
    # extractor over one triple, two DPO steps from the checkpoint
    from slamkit_tpu_torch.cli import extract_features as cli_extract
    from slamkit_tpu_torch.cli import preference_alignment_feature_extractor as cli_pref_fe
    from slamkit_tpu_torch.cli import preference_alignment_train as cli_dpo
    from slamkit_tpu_torch.cli import prepare_tokens as cli_prepare
    from slamkit_tpu_torch.tools.slam_recipe import write_preference_rows

    fe = [f"tokeniser.feature_extractor.pretrained_model={d}/hubert",
          f"tokeniser.feature_extractor.kmeans_path={d}/km.npy",
          "tokeniser.feature_extractor.layer=1", "device=cpu"]
    assert cli_extract.extract_features([f"data_path={d}/pair", "ext=wav", "num_workers=1",
                                         f"out_path={d}/features.jsonl", *fe]) == 2
    assert cli_prepare.prepare_tokens([f"data_path={d}/features.jsonl", "+device=cpu",
                                       f"out_path={d}/tokens.jsonl", "n_threads=2"]) == 2
    wavs = [os.path.join(d, "pair", f"{i}+x.wav") for i in range(2)]
    with open(os.path.join(d, "triples.jsonl"), "w") as f:
        f.write(json.dumps({"prompt_path": wavs[0], "chosen_path": wavs[1],
                            "rejected_path": wavs[0]}) + "\n")
    assert cli_pref_fe.extract_features([f"data_path={d}/triples.jsonl",
                                         f"out_path={d}/pref_features.jsonl", *fe]) == 1
    write_preference_rows(os.path.join(d, "pref.jsonl"), 4, prompt_len=8, completion_len=4)
    state = cli_dpo.train([f"model.pretrained_model={d}/run/checkpoint-2",
                           f"data.train_path={d}/pref.jsonl", f"data.val_path={d}/pref.jsonl",
                           f"training_args.output_dir={d}/dpo", "training_args.max_steps=2",
                           "training_args.per_device_train_batch_size=2",
                           "training_args.logging_steps=1", "training_args.use_cpu=true",
                           "model.config_args.torch_dtype=float32"])
    assert state.global_step == 2, state
    assert os.path.isfile(os.path.join(d, "dpo", "checkpoint-2", "params.npz"))
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", bad)
"""

# the smoke's phases 9-11 at tiny widths: phase 11 reads phase 9's HuBERT
# directory and WAVs and phase 10's features
_NO_JAX_SIMS = _BLOCKER + r"""
import pathlib
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke
from slamkit_tpu_torch.feature_extractor import HubertConfig

torch.set_num_threads(1)
narrow = ["model.config_args.torch_dtype=float32"] + [
    f"+model.config_args.{k}={v}" for k, v in dict(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, intermediate_size=128).items()]
hcfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                    hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                    intermediate_size=64, num_conv_pos_embeddings=8,
                    num_conv_pos_embedding_groups=4)
vcfg = {**chip_smoke.CODEHIFIGAN_CFG, "model_in_dim": 16, "embedding_dim": 16,
        "upsample_initial_channel": 16, "upsample_rates": [4, 2],
        "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
        "resblock_dilation_sizes": [[1, 3], [1, 3]],
        "dur_predictor_params": {"encoder_embed_dim": 16, "var_pred_hidden_dim": 16,
                                 "var_pred_kernel_size": 3}}
cpu = torch.device("cpu")
with tempfile.TemporaryDirectory() as d:
    d = pathlib.Path(d)
    chip_smoke.run_cli(cpu, "cpu", d, model_overrides=narrow, hubert_cfg=hcfg, n_rows=24,
                       lengths=(10, 40), context=64, batch=2, accum=1, n_pairs=2,
                       seconds=(0.3, 0.5))
    chip_smoke.run_dpo(cpu, "cpu", d, hubert_cfg=hcfg, n_triples=1,
                       triple_seconds=(0.3, (0.2, 0.3)), n_train=2, n_val=1, batch=1,
                       prompt_len=10, completion_len=5, steps=2)
    result = chip_smoke.run_sims(cpu, "cpu", d, tiny=True, n_entries=804, hubert_cfg=hcfg,
                                 voc_cfg=vcfg, n_rows=8, lengths=(30, 90), context=64,
                                 batch=2, accum=1, n_triples=2, triple_seconds=(0.3, 0.4),
                                 n_prompts=1, max_new_tokens=3)
    assert result["generate"]["TEXT"]["files"] == ["generate_0.txt"], result
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", bad)
"""


# the smoke's phases 9 and 12 at tiny widths: GenPPL and the judge through
# cli.eval, on phase 9's checkpoint, HuBERT directory and WAVs
_NO_JAX_GENPPL = _BLOCKER + r"""
import pathlib
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke
from slamkit_tpu_torch.feature_extractor import HubertConfig

torch.set_num_threads(1)
narrow = ["model.config_args.torch_dtype=float32"] + [
    f"+model.config_args.{k}={v}" for k, v in dict(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, intermediate_size=128).items()]
hcfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                    hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                    intermediate_size=64, num_conv_pos_embeddings=8,
                    num_conv_pos_embedding_groups=4)
vcfg = {**chip_smoke.CODEHIFIGAN_CFG, "model_in_dim": 16, "embedding_dim": 16,
        "upsample_initial_channel": 16, "upsample_rates": [4, 2],
        "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
        "resblock_dilation_sizes": [[1, 3], [1, 3]],
        "dur_predictor_params": {"encoder_embed_dim": 16, "var_pred_hidden_dim": 16,
                                 "var_pred_kernel_size": 3}}
cpu = torch.device("cpu")
with tempfile.TemporaryDirectory() as d:
    d = pathlib.Path(d)
    chip_smoke.run_cli(cpu, "cpu", d, model_overrides=narrow, hubert_cfg=hcfg, n_rows=24,
                       lengths=(10, 40), context=64, batch=2, accum=1, n_pairs=2,
                       seconds=(0.3, 0.5))
    result = chip_smoke.run_genppl(cpu, "cpu", d, tiny=True, hubert_cfg=hcfg, voc_cfg=vcfg,
                                   n_files=3, batch=2, max_new_tokens=5)
    runs = result["runs"]
    assert runs["asr_perplexity"]["transcripts"] == 3 and runs["llm_as_judge"]["judged"] == 3
    assert result["card_vs_cpu_logit_rel_err"] == 0.0 and result["whisper_encoder_rel_err"] == 0.0
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", bad)
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"   # one thread beside the gate's other workers
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_port_imports_and_runs_without_jax():
    proc = _run([sys.executable, "-c", _NO_JAX], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout, proc.stdout


def test_sims_path_runs_without_jax_transformers_or_tokenizers():
    proc = _run([sys.executable, "-c", _NO_JAX_SIMS], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
    assert "cli.eval metric=cm_ms_tsc: StoryCloze" in proc.stdout


def test_genppl_path_runs_without_jax_transformers_nltk_or_openai():
    proc = _run([sys.executable, "-c", _NO_JAX_GENPPL], cwd=ROOT, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
    assert "cli.eval metric=asr_perplexity: asr_perplexity" in proc.stdout
    assert "cli.eval metric=llm_as_judge: llm_as_judge" in proc.stdout


def test_port_sources_never_import_jax():
    """No import of jax, the JAX package, PyYAML, transformers, tokenizers,
    safetensors, nltk or openai anywhere in the port or in chip_smoke.py; the
    scan covers every module, the DPO, data-preparation, SIMS and GenPPL ones
    included. The one exception is OpenAIJudge's import of openai inside its
    constructor, which runs only when a user names an OpenAI judge."""
    banned = ("jax", "slamkit_tpu", "yaml", "transformers", "tokenizers", "safetensors",
              "nltk", "openai")
    allowed = {("slamkit_tpu_torch/metric/metric_utils.py", "from openai import OpenAI")}
    paths = [*(ROOT / "slamkit_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    scanned = {str(p.relative_to(ROOT)) for p in paths}
    assert {f"slamkit_tpu_torch/{m}.py" for m in (
        "cli/extract_features", "cli/prepare_tokens", "cli/preference_alignment_train",
        "cli/preference_alignment_feature_extractor", "trainer/slam_dpo_trainer",
        "data/preference", "data/prepare", "utils/calculation_utils",
        "tokeniser/text_tokeniser", "tokeniser/interleaving_tokeniser",
        "metric/cross_modal_metric", "metric/cross_modal_generation", "models/token_lm",
        "tools/sims_recipe", "tools/genppl_recipe", "metric/whisper",
        "metric/whisper_features", "metric/metric_utils", "metric/generative_metric",
        "utils/word_tokenize")} <= scanned
    seen_allowed = set()
    for path in paths:
        rel = str(path.relative_to(ROOT))
        for line in path.read_text().splitlines():
            words = line.split()
            if (rel, line.strip()) in allowed and line.startswith(" "):
                seen_allowed.add((rel, line.strip()))
                continue
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] in banned), (path, line)
    assert seen_allowed == allowed


def test_chip_smoke_fails_without_cuda():
    proc = _run([sys.executable, "chip_smoke.py"], cwd=ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as mod
    finally:
        sys.path.remove(str(ROOT))
    return mod


def test_chip_smoke_tokenises_like_unit_tokeniser(chip_smoke):
    from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser, pad_token_batch

    rng = np.random.default_rng(0)
    reprs = chip_smoke._unit_strings(rng, [5, 17, 1, 9])
    tok = UnitTokeniser(load_fe=False)
    want = tok.string_tokenise(reprs, padding=True)["input_ids"]
    np.testing.assert_array_equal(chip_smoke.tokenise_units(reprs), want)
    # build_prompt: drop the trailing <S>, pad on the left
    prompts = pad_token_batch([tok._encode_one(s)[:-1] for s in reprs], tok.pad_token_id,
                              "left")["input_ids"]
    np.testing.assert_array_equal(chip_smoke.tokenise_units(reprs, prompt=True), prompts)


def test_chip_smoke_slice_rehearsal_on_cpu(chip_smoke, capsys):
    """The smoke's scoring and generation phases end to end on the CPU at a
    2-layer width: the plain attention runs and no kernel launch is counted."""
    import dataclasses

    import torch

    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    cfg = dataclasses.replace(slam_config(), torch_dtype="float32",
                              config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                                    num_attention_heads=4,
                                                    num_key_value_heads=2, head_dim=16,
                                                    intermediate_size=128))
    result = chip_smoke.run_slice(torch.device("cpu"), "cpu rehearsal", cfg=cfg)
    assert result["launches"] == 0
    assert result["nll_err"] < 1e-5
    assert set(result["generation"]) == {"sample", "greedy"}
    json.dumps(result)
    assert "scoring: 8 requests" in capsys.readouterr().out


def test_chip_smoke_training_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """The smoke's training and card-vs-CPU phases end to end on the CPU at a
    2-layer width: four steps with a save at step 3, a resumed run that
    repeats step 4, the export reloaded; no kernel launch is counted."""
    import dataclasses

    import torch

    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    cfg = dataclasses.replace(slam_config(), torch_dtype="float32",
                              config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                                    num_attention_heads=4,
                                                    num_key_value_heads=2, head_dim=16,
                                                    intermediate_size=128))
    cpu = torch.device("cpu")
    result = chip_smoke.run_training(cpu, "cpu rehearsal", cfg=cfg, work=tmp_path, n_rows=80,
                                     lengths=(10, 60), context_len=64,
                                     per_device_train_batch_size=2,
                                     gradient_accumulation_steps=2)
    assert result["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert result["resume_err"] == 0.0
    assert result["losses"][-1] < result["losses"][0]
    json.dumps(result)
    check = chip_smoke.check_card_vs_cpu(cpu, tmp_path, cfg=cfg, context=64)
    assert check["loss_err"] < 1e-5 and check["min_grad_cosine"] > 0.9999
    assert "resume from checkpoint-3" in capsys.readouterr().out


def test_chip_smoke_speech_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """The smoke's speech-continuation phase end to end on the CPU at tiny
    widths: WAV prompts through generative_metric.generate, int8 then dense,
    eight finite waveforms each, and the card-vs-CPU checks (here CPU against
    CPU, so exact); the plain versions run and no kernel launch is counted."""
    import dataclasses

    import torch

    from slamkit_tpu_torch.feature_extractor import HubertConfig
    from slamkit_tpu_torch.tools.slam_recipe import slam_config

    lm_cfg = dataclasses.replace(slam_config(), torch_dtype="float32",
                                 config_overrides=dict(num_hidden_layers=2, hidden_size=64,
                                                       num_attention_heads=4,
                                                       num_key_value_heads=2, head_dim=16,
                                                       intermediate_size=128))
    hubert_cfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                              hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                              intermediate_size=64, num_conv_pos_embeddings=8,
                              num_conv_pos_embedding_groups=4)
    voc_cfg = {**chip_smoke.CODEHIFIGAN_CFG, "model_in_dim": 16, "embedding_dim": 16,
               "upsample_initial_channel": 16, "upsample_rates": [4, 2],
               "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
               "resblock_dilation_sizes": [[1, 3], [1, 3]],
               "dur_predictor_params": {"encoder_embed_dim": 16, "var_pred_hidden_dim": 16,
                                        "var_pred_kernel_size": 3, "var_pred_dropout": 0.5}}
    result = chip_smoke.run_speech(
        torch.device("cpu"), "cpu rehearsal", tmp_path, lm_cfg=lm_cfg, hubert_cfg=hubert_cfg,
        voc_cfg=voc_cfg, seconds=0.3,
        generate_kwargs=dict(chip_smoke.GENERATE_KWARGS, max_new_tokens=5))
    for name in ("int8", "dense"):
        run = result["runs"][name]
        assert run["launches"] == {"dq_matmul": 0, "flash_fwd": 0}
        assert run["generate_calls"] == 1 and run["new_tokens_per_s"] > 0
        assert run["prompt_ids"][0][0] == 8
    assert result["hubert_rel_err"] == 0.0 and result["unit_agreement"] == 1.0
    assert result["int8_logit_err"] == 0.0
    assert result["dq_held_calls"] == 2 * 7 * 2 and result["dq_held_max_ulps"] == 0.0
    assert result["duration_agreement"] == 1.0 and result["vocoder_err"] == 0.0
    json.dumps(result)
    assert "speech (int8): 8 prompts of 0.3 s" in capsys.readouterr().out


def test_chip_smoke_cli_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """The smoke's command-line phase end to end on the CPU at narrow widths:
    cli.train on model=slam (twist_init true, the TWIST fallback logged) for
    2 steps with a save and a trace, the reload through
    model.pretrained_model with remat, cli.eval on 4 pairs; no kernel launch
    is counted and the CPU check is exact."""
    import torch

    from slamkit_tpu_torch.feature_extractor import HubertConfig

    narrow = ["model.config_args.torch_dtype=float32"] + [
        f"+model.config_args.{k}={v}" for k, v in dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128).items()]
    hubert_cfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                              hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                              intermediate_size=64, num_conv_pos_embeddings=8,
                              num_conv_pos_embedding_groups=4)
    result = chip_smoke.run_cli(torch.device("cpu"), "cpu rehearsal", tmp_path,
                                model_overrides=narrow, hubert_cfg=hubert_cfg, n_rows=48,
                                lengths=(10, 60), context=64, batch=2, accum=2, n_pairs=4,
                                seconds=(0.2, 0.4))
    assert result["train_launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert result["eval_launches"] == 0 and result["eval_calls"] == 2   # pos, neg
    assert result["reload_remat"] and result["card_vs_cpu_ll_err"] == 0.0
    assert result["twist"].startswith("TWIST init requested")
    assert len(result["losses"]) == 2 and result["trace_bytes"] > 0
    json.dumps(result)
    assert "cli.eval: sBLIMP" in capsys.readouterr().out


def test_chip_smoke_dpo_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """The smoke's phase 10 end to end on the CPU at narrow widths, in phase
    9's work directory (phase 9 at its rehearsal's widths first): stage 1
    and 2 held to direct audio_represent calls, the preference extractor,
    4 DPO steps from phase 9's checkpoint with a step-1 loss of ln 2, the
    resumed run repeating step 4 exactly, the export, and the card-vs-CPU
    check (here CPU against CPU, so exact); no kernel launch is counted."""
    import torch

    from slamkit_tpu_torch.feature_extractor import HubertConfig

    narrow = ["model.config_args.torch_dtype=float32"] + [
        f"+model.config_args.{k}={v}" for k, v in dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128).items()]
    hubert_cfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                              hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                              intermediate_size=64, num_conv_pos_embeddings=8,
                              num_conv_pos_embedding_groups=4)
    cpu = torch.device("cpu")
    chip_smoke.run_cli(cpu, "cpu rehearsal", tmp_path, model_overrides=narrow,
                       hubert_cfg=hubert_cfg, n_rows=48, lengths=(10, 60), context=64, batch=2,
                       accum=2, n_pairs=4, seconds=(0.2, 0.4))
    result = chip_smoke.run_dpo(cpu, "cpu rehearsal", tmp_path, hubert_cfg=hubert_cfg,
                                n_triples=3, triple_seconds=(0.4, (0.2, 0.3)), n_train=8,
                                n_val=3, batch=2, prompt_len=20, completion_len=10)
    assert result["stage1_files"] == result["stage2_lines"] == 8 and result["pref_rows"] == 3
    assert result["dpo_shape"] == [4, 32] and result["remat"]
    assert result["launches"] == result["resumed_launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert abs(result["losses"][0] - np.log(2)) < 1e-6 and result["resume_err"] == 0.0
    check = result["card_vs_cpu"]
    assert check["loss_err"] == 0.0 and check["min_grad_cosine"] > 0.9999
    json.dumps(result)
    assert "DPO resume from checkpoint-3" in capsys.readouterr().out


def test_chip_smoke_sims_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """The smoke's phase 11 end to end on the CPU at tiny widths, in the work
    directory of phases 9 and 10 (run first at their rehearsal's widths):
    stage 2 with the interleaving tokeniser held to direct calls, cli.train
    --config-name train_inter_scale on the 4-layer base, cm_ms_tsc with its
    CPU check (here CPU against CPU, so exact), cm_generate both ways with
    the vocoder's WAVs and the text files; no kernel launch is counted."""
    import torch

    from slamkit_tpu_torch.feature_extractor import HubertConfig

    narrow = ["model.config_args.torch_dtype=float32"] + [
        f"+model.config_args.{k}={v}" for k, v in dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128).items()]
    hubert_cfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                              hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                              intermediate_size=64, num_conv_pos_embeddings=8,
                              num_conv_pos_embedding_groups=4)
    voc_cfg = {**chip_smoke.CODEHIFIGAN_CFG, "model_in_dim": 16, "embedding_dim": 16,
               "upsample_initial_channel": 16, "upsample_rates": [4, 2],
               "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
               "resblock_dilation_sizes": [[1, 3], [1, 3]],
               "dur_predictor_params": {"encoder_embed_dim": 16, "var_pred_hidden_dim": 16,
                                        "var_pred_kernel_size": 3, "var_pred_dropout": 0.5}}
    cpu = torch.device("cpu")
    chip_smoke.run_cli(cpu, "cpu rehearsal", tmp_path, model_overrides=narrow,
                       hubert_cfg=hubert_cfg, n_rows=48, lengths=(10, 60), context=64, batch=2,
                       accum=2, n_pairs=4, seconds=(0.4, 0.8))
    chip_smoke.run_dpo(cpu, "cpu rehearsal", tmp_path, hubert_cfg=hubert_cfg, n_triples=2,
                       triple_seconds=(0.4, (0.2, 0.3)), n_train=4, n_val=2, batch=2,
                       prompt_len=20, completion_len=10, steps=2)
    result = chip_smoke.run_sims(cpu, "cpu rehearsal", tmp_path, tiny=True, n_entries=804,
                                 hubert_cfg=hubert_cfg, voc_cfg=voc_cfg, n_rows=12,
                                 lengths=(40, 120), context=128, batch=2, accum=2,
                                 n_triples=3, triple_seconds=(0.3, 0.5), n_prompts=2,
                                 max_new_tokens=5)
    assert result["vocab"] == 804 + 502 and result["stage2_lines"] == 8
    assert result["train_launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert len(result["losses"]) == 2 and result["cm_calls"] == 2        # correct, incorrect
    assert result["cm_launches"] == 0 and result["card_vs_cpu_ll_err"] == 0.0
    assert 0.0 <= result["storycloze"] <= 1.0
    for mod in ("SPEECH", "TEXT"):
        run = result["generate"][mod]
        assert run["in_modality"] and run["launches"] == 0 and run["calls"] == 1
    assert all(f.endswith(".txt") for f in result["generate"]["TEXT"]["files"])
    json.dumps(result)
    assert "cli.eval metric=cm_generate SPEECH->TEXT" in capsys.readouterr().out


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kind", ["packed", "left_padded", "dead_rows"])
def test_chip_smoke_counts_visible_pairs(chip_smoke, causal, kind):
    """The attention bound counts the pairs this case's segment ids let
    through, as a brute-force count of the mask does."""
    rng = np.random.default_rng(3)
    b, t = 3, 70
    kv = None
    if kind == "packed":
        seg = chip_smoke._packed_segments(rng, b, t, 4)
    elif kind == "left_padded":
        seg = chip_smoke._left_padded(rng, b, t)
    else:
        seg = np.zeros((b, t), np.int32)
        seg[:, 10:20] = 7
        kv = np.zeros((b, t), np.int32)
    keys = seg if kv is None else kv
    mask = seg[:, :, None] == keys[:, None, :]
    if causal:
        mask &= np.tril(np.ones((t, t), bool))
    assert chip_smoke.visible_pairs(seg, kv, causal) == int(mask.sum())
    n_bytes, flops = chip_smoke.flash_cost((b, 4, 2, t, 16), seg, kv, causal, backward=False)
    assert flops == 4 * 16 * 4 * int(mask.sum())
    ids = b * t * 4 * (1 if kv is None else 2)
    assert n_bytes == 2 * (b * 4 * t * 16 * 2) + 2 * (b * 2 * t * 16 * 2) + b * 4 * t * 4 + ids
    n_bytes_bwd, flops_bwd = chip_smoke.flash_cost((b, 4, 2, t, 16), seg, kv, causal,
                                                   backward=True)
    assert flops_bwd == 10 * 16 * 4 * int(mask.sum())
    assert n_bytes_bwd == n_bytes + 2 * (b * 4 * t * 16 * 2) + 2 * (b * 2 * t * 16 * 2)


def test_chip_smoke_bound_takes_the_larger_time(chip_smoke):
    ms, by = chip_smoke.bound_ms(3.35e9, 1.0)           # 3.35 GB at 3.35 TB/s
    assert by == "bytes" and abs(ms - 1.0) < 1e-12
    ms, by = chip_smoke.bound_ms(1.0, 989e9)            # 989 GFLOP at 989 TFLOP/s
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    share, vs = chip_smoke._ratios(2.0, 1.0, 4.0)
    assert share == 0.5 and vs == 0.5
    assert chip_smoke._ratios(2.0, 1.0, None)[1] is None



def test_chip_smoke_f32_bound_counts_float32_bytes_at_the_fp32_rate(chip_smoke):
    """Phase 3e's bound: q, k, v and out of 4 bytes an element, and the
    operations at the float32 CUDA-core rate (67 TFLOP/s), not the bf16
    tensor cores'."""
    seg = np.zeros((2, 64), np.int32)
    n16, f16 = chip_smoke.flash_cost((2, 4, 2, 64, 16), seg, None, True, backward=False)
    n32, f32 = chip_smoke.flash_cost((2, 4, 2, 64, 16), seg, None, True, backward=False,
                                     elt_bytes=4)
    elems = 2 * (2 * 4 * 64 * 16) + 2 * (2 * 2 * 64 * 16)
    assert f16 == f32 and n32 - n16 == 2 * elems
    ms, by = chip_smoke.bound_ms(1.0, 67e9, flops_per_s=chip_smoke.FP32_FLOPS_PER_S)
    assert by == "operations" and abs(ms - 1.0) < 1e-12


@pytest.mark.parametrize("left", [False, True])
def test_chip_smoke_holds_a_launch_to_plain_in_row_chunks(chip_smoke, monkeypatch, left):
    """Phase 3e's and 12's plain version, run batch rows at a time under the
    score budget, equals one mha_reference call; a launch whose (out, lse)
    is the plain version's holds, at the plain version's own distance from
    float64, one that is off by 1e-3 fails, and the pads of a judge prefill
    read as left padding."""
    import torch

    from slamkit_tpu_torch.ops import mha_reference

    rng = np.random.default_rng(3)
    b, h, hkv, t, d = 3, 4, 2, 96, 16
    q, k, v = (torch.from_numpy(rng.standard_normal((b, n, t, d)).astype(np.float32))
               for n in (h, hkv, hkv))
    seg = torch.from_numpy(chip_smoke._left_padded(rng, b, t, most=30) if left
                           else chip_smoke._right_padded(rng, b, t, lo=60))
    want = mha_reference(q, k, v, segment_ids=seg, causal=True)
    monkeypatch.setattr(chip_smoke, "PLAIN_SCORE_BYTES", h * t * t * 4)   # one row a chunk
    out, lse, chunks = chip_smoke._plain_fwd(q, k, v, seg, None, True)
    assert chunks == b
    torch.testing.assert_close(out, want[0], atol=0, rtol=0)
    torch.testing.assert_close(lse, want[1], atol=0, rtol=0)
    args = (q, k, v, seg, seg, True, d ** -0.5)
    held = chip_smoke.hold_launch(args, want)
    assert held["ok"] and held["max_abs_err_out"] == held["max_abs_err_lse"] == 0.0
    assert held["f64_err_out"] == held["plain_f64_err_out"] < 1e-5
    assert held["out_bound"] == chip_smoke.F32_OUT_BOUND
    assert held["left_padded"] == left and held["shape"] == [b, h, hkv, t, d]
    assert held["pads"] == (seg == -1).sum(1).tolist()
    assert not chip_smoke.hold_launch(args, (want[0] + 1e-3, want[1]))["ok"]


@pytest.mark.parametrize("causal", [True, False])
def test_chip_smoke_f64_reference_keeps_the_kernels_edge_rules(chip_smoke, causal):
    """Phase 12's float64 yardstick computes the plain version's function,
    GQA kv-major, with its dead rows (query ids no key carries) at out 0
    and LSE 1e30."""
    import torch

    from slamkit_tpu_torch.ops import mha_reference

    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, 80, 16)).astype(np.float32))
               for n in (4, 2, 2))
    seg = torch.zeros((2, 80), dtype=torch.int32)
    seg[:, 10:20] = 7
    kv_seg = torch.zeros_like(seg)
    out, lse = chip_smoke._f64_fwd(q, k, v, seg, kv_seg, causal, 0.3)
    want, want_lse = mha_reference(q, k, v, segment_ids=seg, causal=causal, sm_scale=0.3,
                                   kv_segment_ids=kv_seg)
    torch.testing.assert_close(out.float(), want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse.float(), want_lse, atol=1e-5, rtol=1e-5)
    assert bool((lse[:, :, 10:20] == 1e30).all()) and bool((out[:, :, 10:20] == 0).all())


def test_chip_smoke_lm_scores_give_log_likelihood(chip_smoke, tmp_path):
    """Phase 12's card-against-CPU text-LM check reads the logits and token
    log-probabilities that get_llm_perplexity averages: their per-text mean
    is its NLL."""
    from slamkit_tpu_torch.metric import metric_utils
    from slamkit_tpu_torch.tools import genppl_recipe

    model, tok = metric_utils.get_llm(genppl_recipe.write_llama_dir(tmp_path, tiny=True),
                                      device="cpu")
    texts = ["a longer transcript, with words", "short"]
    logits, logp, counts = chip_smoke.lm_scores(model, tok, texts)
    assert logits.shape == (sum(counts), model.decoder.cfg.vocab_size) and len(logp) == sum(counts)
    nll = np.array([-float(x.mean()) for x in logp.split(counts)])
    np.testing.assert_allclose(nll, metric_utils.get_llm_perplexity(model, tok, texts),
                               rtol=1e-6)


def test_chip_smoke_genppl_rehearsal_on_cpu(chip_smoke, tmp_path, capsys):
    """The smoke's phase 12 end to end on the CPU at tiny widths, in phase
    9's work directory (run first at its rehearsal's widths): both Whisper
    and Llama directories written, cli.eval metric=asr_perplexity and
    metric=llm_as_judge with alignment prompts and the vocoder, every stage
    timed, the CPU checks (here CPU against CPU, so exact); no kernel launch
    is counted."""
    import torch

    from slamkit_tpu_torch.feature_extractor import HubertConfig

    narrow = ["model.config_args.torch_dtype=float32"] + [
        f"+model.config_args.{k}={v}" for k, v in dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=128).items()]
    hubert_cfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                              hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                              intermediate_size=64, num_conv_pos_embeddings=8,
                              num_conv_pos_embedding_groups=4)
    voc_cfg = {**chip_smoke.CODEHIFIGAN_CFG, "model_in_dim": 16, "embedding_dim": 16,
               "upsample_initial_channel": 16, "upsample_rates": [4, 2],
               "upsample_kernel_sizes": [8, 4], "resblock_kernel_sizes": [3, 5],
               "resblock_dilation_sizes": [[1, 3], [1, 3]],
               "dur_predictor_params": {"encoder_embed_dim": 16, "var_pred_hidden_dim": 16,
                                        "var_pred_kernel_size": 3, "var_pred_dropout": 0.5}}
    cpu = torch.device("cpu")
    chip_smoke.run_cli(cpu, "cpu rehearsal", tmp_path, model_overrides=narrow,
                       hubert_cfg=hubert_cfg, n_rows=24, lengths=(10, 40), context=64, batch=2,
                       accum=1, n_pairs=3, seconds=(0.4, 0.8))
    result = chip_smoke.run_genppl(cpu, "cpu rehearsal", tmp_path, tiny=True,
                                   hubert_cfg=hubert_cfg, voc_cfg=voc_cfg, n_files=4, batch=3,
                                   max_new_tokens=5)
    asr, judge = result["runs"]["asr_perplexity"], result["runs"]["llm_as_judge"]
    assert asr["transcripts"] == 4 and asr["generate_calls"] == asr["f32_calls"] == 2
    assert asr["asr_perplexity"] > 0 and 0.0 <= asr["auto_bleu"] <= 1.0
    assert judge["judged"] == 4 and judge["generate_calls"] == judge["f32_calls"] == 2
    for run in (asr, judge):
        assert run["launches"] == {"flash_fwd": 0, "flash_fwd_f32": 0}
        assert len(run["transcribe_seconds"]) >= run["generate_calls"]
    assert set(asr["load_seconds"]) == {"load_whisper", "load_llm"}
    assert set(judge["load_seconds"]) == {"load_whisper", "load_judge"}
    assert result["card_vs_cpu_logit_rel_err"] == result["card_vs_cpu_logp_err"] == 0.0
    assert result["whisper_logit_rel_err"] == 0.0 and result["f32_held"] == {}
    assert result["whisper_tokens_equal"] == 1.0
    json.dumps(result)
    assert "Whisper card vs float32 CPU on one window" in capsys.readouterr().out


def test_chip_smoke_kernel_row_keeps_eager_and_graph_times_apart(chip_smoke):
    """`ms` and `plain_ms` stay eager times; the graph times, the library
    time and the ratios reckoned from them have keys of their own."""
    at = dict(ms=0.30, plain_ms=5.0, device_ms=0.20, plain_device_ms=4.0, bound_ms=0.02,
              bound_by="bytes", library_ms=None, library="none: its graph capture failed",
              roofline_share=0.1, vs_library=None)
    row = chip_smoke.kernel_row("k", "a.cu", "b.py:1", ["prep", "main", "tail"], 7, 0.01, at)
    assert (row["ms"], row["plain_ms"], row["graph_ms"], row["plain_graph_ms"]) == (
        0.30, 5.0, 0.20, 4.0)
    assert row["launches"] == 7 and row["kernels_per_launch"] == 3
    assert row["library_ms"] is None and row["library_timed"].startswith("none")
    assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"} <= row.keys()


def test_chip_smoke_prefill_entry_names_the_gemm_and_its_graph_times(chip_smoke):
    """The dq_matmul entry's `prefill` sub-entry carries the prefill GEMM's
    own phase-3c row: its shape, graph times under the kernels line's names,
    and the dense path's time beside them."""
    at = dict(m=1024, k=896, n=4864, ms=0.04, plain_ms=0.3, device_ms=0.03,
              plain_device_ms=0.27, bound_ms=0.009, bound_by="operations", library_ms=9.8,
              roofline_share=0.3, vs_library=0.003, tflops=289.0, dense_graph_ms=0.016)
    entry = chip_smoke.prefill_entry(at)
    assert entry["cuda_kernel"] == "dq_gemm_kernel" and entry["shape"] == [1024, 896, 4864]
    assert (entry["graph_ms"], entry["plain_graph_ms"], entry["ms"]) == (0.03, 0.27, 0.04)
    assert (entry["bound_ms"], entry["library_ms"], entry["dense_graph_ms"]) == (
        0.009, 9.8, 0.016)


def test_chip_smoke_reports_the_error_that_broke_a_capture(chip_smoke):
    """A capture that fails inside the graph surfaces at `capture_end` as
    "a previous error"; the note names the error that caused it."""
    with pytest.raises(RuntimeError) as caught:
        try:
            raise RuntimeError("operation not permitted when stream is capturing\nmore")
        finally:
            raise RuntimeError("operation failed due to a previous error during capture")
    assert chip_smoke._first_error(caught.value) == (
        "RuntimeError: operation not permitted when stream is capturing")
    assert chip_smoke._library_text(None, "none: why", None) == "library none: why"
