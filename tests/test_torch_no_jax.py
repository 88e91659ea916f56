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
and text LM); the data path (the smoke's phase 14 at tiny widths: FLAC
through `cli.extract_features ext=flac`, `kmeans_fit`, `cli.train` with the
token spill and the `saved_ds_path` cache, then as on a host without libav);
and
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
    # dropout, attention dropout on the plain attention, layerdrop, qkv remat
    # and Adafactor
    drop_lm = UnitLM(UnitLMConfig(base_model_name="EleutherAI/pythia-14m", vocab_size=502,
                                  twist_init=False, torch_dtype="float32", remat=True,
                                  remat_policy="qkv", dropout=0.1, attention_dropout=0.1,
                                  layerdrop=0.1, attn_implementation="xla"), device="cpu")
    state = SLAMTrainer(drop_lm, {**args, "optim": "adafactor",
                                  "output_dir": os.path.join(d, "drop")},
                        ds, packing=True, context_len=64).train()
    assert state.global_step == 2, state

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


# the smoke's phases 9, 10 and 16 at tiny widths, phase 16 at the shipped
# bases' own widths where the CPU takes them: train_inter_scale on pythia-14m
# (6 x 128, 4 heads of 32) through its tokenizer.json, bf16 settings resumed
# bit for bit and float32; float32 SIMS on the tiny Qwen2 base; stage 2
# through GPT-2 vocab.json + merges.txt; sstorycloze, generate (null, SPEECH,
# TEXT) and asr_perplexity through the interleaving tokeniser
_NO_JAX_SIMS_DEFAULTS = _BLOCKER + r"""
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
    r = chip_smoke.run_sims_defaults(cpu, "cpu", d, tiny=True, n_rows=12, lengths=(30, 90),
                                     context=128, batch=2, qwen_entries=804, qwen_batch=2,
                                     qwen_accum=2, cpu_tokens=32, hubert_cfg=hcfg,
                                     voc_cfg=vcfg, n_stories=2, story_seconds=(0.3, 0.4),
                                     n_prompts=2, max_new_tokens=3)
    assert r["resume_exact"] and r["bfloat16"]["layers"] == 6, r
    assert r["launches"] == dict.fromkeys(r["launches"], 0), r
    assert r["qwen_f32"]["card_vs_cpu"]["loss_rel_err"] == 0.0, r
    assert r["stage2"]["vocab"] == 50265 + 502 and r["stage2"]["lines"] == 4, r
    assert sorted(r["metrics"]) == ["asr_perplexity", "generate_SPEECH", "generate_TEXT",
                                    "generate_null", "sstorycloze"], r
    assert all(m["finite"] for m in r["metrics"].values()), r
    assert not (d / "sims_defaults").exists()
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


# the smoke's phase 14 at tiny widths: FLAC through the native decoder into
# cli.extract_features (ext=flac), kmeans_fit, cli.train on two corpora with
# the spill and the saved_ds_path cache; then again as on a host without
# libav, where FLAC must raise and the WAV twins stand in, said so
_NO_JAX_DATA = _BLOCKER + r"""
import pathlib
import torch
sys.path.insert(0, os.getcwd())
import chip_smoke
from slamkit_tpu_torch.feature_extractor import HubertConfig
from slamkit_tpu_torch.feature_extractor.hubert import random_params, save_hf_dir
from slamkit_tpu_torch.native import _build, bindings

torch.set_num_threads(1)
narrow = ["model.config_args.torch_dtype=float32"] + [
    f"+model.config_args.{k}={v}" for k, v in dict(
        num_hidden_layers=2, hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, intermediate_size=128).items()]
hcfg = HubertConfig(conv_dim=(32,) * 3, conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
                    hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                    intermediate_size=64, num_conv_pos_embeddings=8,
                    num_conv_pos_embedding_groups=4)
cpu = torch.device("cpu")
tiny = dict(hubert_cfg=hcfg, model_overrides=narrow, n_files=4, seconds=(0.3, 0.6),
            fit_rows=3000, fit_dim=32, k=12, fit_iters=3, fit_batch=700, subset_rows=1000,
            subset_iters=2, corpus_tokens=12000, spill_tokens=3000, lengths=(10, 60),
            context=64, batch=2, steps=2)
results = []
with tempfile.TemporaryDirectory() as d:
    d = pathlib.Path(d)
    save_hf_dir(str(d / "hubert"), random_params(hcfg, seed=3), hcfg)
    results.append(chip_smoke.run_data_path(cpu, "cpu", d, **tiny))

    def no_libav():
        raise _build.NativeUnavailable("g++ failed building libaudio.so: no libav headers")

    bindings._lib, chip_smoke._libav_versions = no_libav, lambda: None
    results.append(chip_smoke.run_data_path(cpu, "cpu", d, **tiny))
assert [r["decode"]["format"] for r in results] == ["flac", "wav"], results
for r in results:
    assert r["kmeans"]["repeat_bitwise"] and r["spill_cache"]["batches"] == 2, r
    assert r["launches"] == {"flash_fwd": 0, "flash_bwd": 0}, r
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


def test_sims_defaults_run_without_jax_transformers_or_tokenizers():
    proc = _run([sys.executable, "-c", _NO_JAX_SIMS_DEFAULTS], cwd=ROOT, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
    out = proc.stdout
    assert "train_inter_scale resumed from checkpoint-1" in out
    assert "stage 2 through vocab.json + merges.txt" in out
    assert "cli.eval asr_perplexity through the interleaving tokeniser" in out


def test_genppl_path_runs_without_jax_transformers_nltk_or_openai():
    proc = _run([sys.executable, "-c", _NO_JAX_GENPPL], cwd=ROOT, timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
    assert "cli.eval metric=asr_perplexity: asr_perplexity" in proc.stdout
    assert "cli.eval metric=llm_as_judge: llm_as_judge" in proc.stdout


def test_data_path_runs_without_jax():
    proc = _run([sys.executable, "-c", _NO_JAX_DATA], cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "LOADED []" in proc.stdout, proc.stdout[-2000:]
    out = proc.stdout
    assert "(d) stage 1 (cli.extract_features, the default ext=flac" in out
    assert "libav: absent on this host" in out and "ext=wav: libav absent" in out
    assert out.count("2 batches bitwise equal from the cache: True, spilled vs in RAM: True") == 2


def test_port_sources_never_import_jax():
    """No import of jax, the JAX package, PyYAML, transformers, tokenizers,
    safetensors, nltk or openai anywhere in the port or in chip_smoke.py; the
    scan covers every module, the DPO, data-preparation, SIMS, GenPPL and
    tensor-parallel ones included (the tp leg runs with them blocked in
    `test_torch_tp_smoke.py`). The one exception is OpenAIJudge's import of openai inside its
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
        "utils/word_tokenize", "native/_build", "native/bindings", "native/codec",
        "native/pack", "utils/data_prep", "utils/tts_utils", "tools/data_recipe",
        "feature_extractor/kmeans", "parallel/__init__", "parallel/mesh",
        "ops/ring_attention", "tools/parallel_smoke", "ops/flash_attention",
        "tokeniser/unit_tokeniser", "models/unit_lm", "models/generate", "cli/eval",
        "trainer/slam_trainer", "parallel/tensor", "parallel/fsdp", "models/transformer",
        "trainer/optim", "trainer/checkpoint", "cli/train", "parallel/multihost",
        "tools/multinode")} <= scanned
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


def test_parallel_smoke_refuses_one_rank_and_a_cpu_host():
    """The multi-card leg refuses fewer than two ranks (or an odd count),
    naming torchrun, and refuses a host without a card."""
    one = _run([sys.executable, "-m", "slamkit_tpu_torch.tools.parallel_smoke"], cwd=ROOT)
    assert one.returncode == 2 and "--nproc_per_node N" in one.stderr, one.stderr
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    two = subprocess.run([sys.executable, "-m", "slamkit_tpu_torch.tools.parallel_smoke"],
                         cwd=ROOT, env={**env, "WORLD_SIZE": "2"}, capture_output=True,
                         text=True, timeout=120)
    assert two.returncode == 1 and "cuda" in two.stderr.lower(), two.stderr
    assert '"ok"' not in one.stdout + two.stdout


def test_multinode_refuses_a_host_without_four_cards():
    """The two-node leg needs four cards (two nodes of two) and says so,
    printing no result; its comparison and transport count read what
    `parallel_smoke` and NCCL write."""
    proc = _run([sys.executable, "-m", "slamkit_tpu_torch.tools.multinode"], cwd=ROOT)
    assert proc.returncode == 1 and "need 4 CUDA cards" in proc.stderr, proc.stderr
    assert proc.stdout == ""


def test_multinode_compares_a_row_and_counts_transports(tmp_path):
    from slamkit_tpu_torch.tools import multinode

    one = {"losses": [6.25, 6.0], "grad_norm_step1": 2.0}
    assert multinode.compare("dp", dict(one), one) == {
        "mesh": "dp", "loss_err": 0.0, "grad_norm_rel_err": 0.0, "losses_equal": True,
        "bound": 0.0, "ok": True}
    # the two nodes over NVLink: bit for bit, every step
    late = {"losses": [6.25, 6.0 + 2e-6], "grad_norm_step1": 2.0}
    got = multinode.compare("dp", late, one)
    assert not got["ok"] and not got["losses_equal"] and got["loss_err"] == pytest.approx(2e-6)
    # over the socket transport: every step within SOCKET_BOUND
    assert multinode.compare("dp", late, one, multinode.SOCKET_BOUND)["ok"]
    for bad in ({"losses": [6.25, 6.0 + 2e-5], "grad_norm_step1": 2.0},
                {"losses": [6.25, 6.0], "grad_norm_step1": 2.0001},
                {"losses": [6.25], "grad_norm_step1": 2.0}):
        assert not multinode.compare("dp", bad, one, multinode.SOCKET_BOUND)["ok"], bad
    (tmp_path / "nccl.host.1").write_text(
        "host:1:2 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM\n"
        "host:1:2 [0] NCCL INFO Channel 01/0 : 0[0] -> 1[1] via P2P/CUMEM\n"
        "host:1:2 [0] NCCL INFO Channel 00/0 : 1[1] -> 2[0] [send] via NET/Socket/0\n"
        "host:1:2 [0] NCCL INFO comm 0x1 rank 0 nranks 4 - Init COMPLETE\n")
    assert multinode.nccl_transports(tmp_path) == {"P2P/CUMEM": 2, "NET/Socket/0": 1}
    assert multinode._last_json('noise\n{"a": 1}\n{"b": 2}\ntrailing\n') == {"b": 2}


def test_parallel_smoke_rehearsal_on_gloo_ranks_without_jax(tmp_path):
    """`tools/parallel_smoke.run` on 2 gloo ranks on the CPU, JAX and the
    rest blocked, at a 2-layer decoder, 2 rows of 512: the one-process
    reference, the meshes (DP [2], CP [1, 2] in both schedules, [2, 1]) with
    their step-1 checks, exact resumes, the ring against one call, DPO on
    [2] against one process with its resume, sharded scoring and generation
    (greedy, int8 and sampled) against one process, and no kernel launch. (The 4-rank meshes of the card run are held on 4 gloo
    ranks by `test_torch_parallel_training.py` and
    `test_torch_ring_attention.py`.)"""
    import torch_mesh_workers

    ranks = torch_mesh_workers.launch("parallel_smoke", 2, tmp_path, timeout=400, block=True,
                                      context=512, rows=2, n_rows=60, lengths=[100, 1001])
    assert all(json.loads(str(r["loaded"])) == [] for r in ranks)
    result = json.loads(str(ranks[0]["result"]))
    assert result["device"] == "cpu" and result["world"] == 2
    assert set(result["meshes"]) == {"dp", "cp_contiguous", "cp_zigzag", "dp_cp"}
    for name, row in result["meshes"].items():
        assert row["resume_exact"] and len(row["losses"]) == 4, (name, row)
        assert row["loss_err"] <= 1e-5 and row["grad_norm_rel_err"] <= 1e-5, (name, row)
        assert row["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 2
        assert ("ring" in row) == (name in ("cp_contiguous", "cp_zigzag"))
    assert result["dp_scaling_efficiency"] > 0
    dpo = result["dpo"]
    assert dpo["resume_exact"] and len(dpo["losses"]) == 3, dpo
    assert dpo["loss_err"] <= 1e-5 and dpo["grad_norm_rel_err"] <= 1e-5, dpo
    assert dpo["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 2
    ev = result["eval"]
    assert ev["ll_bitwise"] and ev["greedy_bitwise"] and ev["int8_greedy_bitwise"], ev
    assert ev["sampled_token_agreement"] == 1.0, ev
    assert ev["launches_by_rank"] == [{"flash_fwd": 0, "dq_matmul": 0}] * 2


#: the sims7b leg's rehearsal: Qwen2.5-7B's config.json with its widths
#: cut to a 2-layer, 64-wide decoder, an 804-entry tokenizer, context 256
SIMS_REHEARSAL = dict(arch=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                                num_key_value_heads=2, intermediate_size=128),
                      entries=804, context=256)


def test_sims7b_leg_rehearsal_on_gloo_ranks_without_jax(tmp_path):
    """`tools/parallel_smoke.run(legs=("sims7b",))` on 2 gloo ranks, JAX and
    the rest blocked: `--config-name train_inter_scale` with
    `training_args.fsdp=true` from the 7B base directory (untied
    embeddings, rope_theta 1e6) at 2 layers, 64 wide: 3 finite steps of 4
    rows of 256, step 1 equal to the unsharded loss a row at a time, its
    gradient norm finite, every parameter moved, no launch and no
    checkpoint."""
    import torch_mesh_workers

    ranks = torch_mesh_workers.launch("parallel_smoke", 2, tmp_path, timeout=300, block=True,
                                      context=256, rows=2, n_rows=30, lengths=[50, 300],
                                      legs=["sims7b"], sims=SIMS_REHEARSAL)
    assert all(json.loads(str(r["loaded"])) == [] for r in ranks)
    row = json.loads(str(ranks[0]["result"]))["sims7b"]
    assert row["mesh_shape"] == [2] and row["fsdp"] and row["rows_a_step"] == 4
    assert row["layers"] == 2 and row["hidden_size"] == 64 and row["vocab_size"] == 804 + 502
    assert len(row["losses"]) == 3 and all(np.isfinite(row["losses"]))
    assert row["loss_err"] <= 1e-5, row
    assert np.isfinite(row["grad_norm_step1"]) and row["grad_norm_step1"] > 0
    assert row["unmoved_parameters"] == [], row
    assert row["launches_by_rank"] == [{"flash_fwd": 0, "flash_bwd": 0}] * 2
    assert row["checkpoint"] is None and row["mfu"] is None
    assert not (tmp_path / "work" / "sims7b").exists()


def test_chip_smoke_ring_rehearsal_on_cpu(chip_smoke, capsys):
    """Phase 17 on the CPU at a small shape: both schedules, float32 and
    bf16 (the plain versions), every check, no launch and no timing."""
    import torch

    result = chip_smoke.run_ring_kernels(torch.device("cpu"), shape=(2, 4, 2, 1024, 16))
    assert result["launches"] == {"flash_fwd": 0, "flash_bwd": 0, "flash_fwd_f32": 0,
                                  "flash_bwd_f32": 0}
    assert [(r["dtype"], r["schedule"]) for r in result["checks"]] == [
        ("bfloat16", "contiguous"), ("bfloat16", "zigzag"), ("float32", "contiguous"),
        ("float32", "zigzag")]
    assert all(r["ok"] for r in result["checks"]) and result["calls"] == []
    assert "phase 17" in capsys.readouterr().out


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
    # sblimp over phase 9's 4 pairs with used_token_modality=SPEECH: one call
    # a side, finite (checked inside), no launch on the CPU
    assert result["speech_sblimp_calls"] == 2 and result["speech_sblimp_launches"] == 0
    assert 0.0 <= result["speech_sblimp"] <= 1.0
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


def test_chip_smoke_wide_head_cases(chip_smoke):
    """Phases 3-3f's d = 256 and d = 160 cases: [4, 8/2, 1024, d], causal and
    not, 4 packed segments, the causal flag where each phase's loop reads
    it, the bound on the original d."""
    fwd = chip_smoke._wide_head_cases(np.random.default_rng(0), with_causal=True)
    bwd = chip_smoke._wide_head_cases(np.random.default_rng(0))
    assert [c[0] for c in fwd] == [c[0] for c in bwd] == [
        "d256", "d256_noncausal", "d160", "d160_noncausal"]
    assert [c[2] for c in fwd] == [c[3] for c in bwd] == [True, False, True, False]
    for f, b in zip(fwd, bwd):
        d = int(f[0][1:4])
        assert f[1] == b[1] == (4, 8, 2, 1024, d)
        np.testing.assert_array_equal(f[3], b[2])
        assert [len(set(row[row >= 0])) for row in f[3]] == [4] * 4
    n_bytes, flops = chip_smoke.flash_cost((4, 8, 2, 1024, 160), fwd[2][3], None, True,
                                           backward=False)
    assert flops == 4 * 160 * 8 * chip_smoke.visible_pairs(fwd[2][3], None, True)


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
    operations at the float32 rate of 3xTF32 on the tensor cores (495 / 3
    TFLOP/s), not the bf16 tensor cores'; the CUDA-core rate (67 TFLOP/s)
    is kept to print beside it."""
    seg = np.zeros((2, 64), np.int32)
    n16, f16 = chip_smoke.flash_cost((2, 4, 2, 64, 16), seg, None, True, backward=False)
    n32, f32 = chip_smoke.flash_cost((2, 4, 2, 64, 16), seg, None, True, backward=False,
                                     elt_bytes=4)
    elems = 2 * (2 * 4 * 64 * 16) + 2 * (2 * 2 * 64 * 16)
    assert f16 == f32 and n32 - n16 == 2 * elems
    ms, by = chip_smoke.bound_ms(1.0, 165e9, flops_per_s=chip_smoke.FP32_3XTF32_FLOPS_PER_S)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    ms, by = chip_smoke.bound_ms(1.0, 67e9, flops_per_s=chip_smoke.FP32_FLOPS_PER_S)
    assert by == "operations" and abs(ms - 1.0) < 1e-12
    assert chip_smoke._cores_text(None) == ""
    assert "0.0901 ms" in chip_smoke._cores_text(0.0901)


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


def test_chip_smoke_shape_entry_carries_a_second_shapes_times(chip_smoke):
    """The flash_fwd_f32 entry's `tp2_slam_f32` sub-entry carries that
    phase-3e row: its shape, eager and graph times, both bounds, the
    library's time and its error, under the kernels line's names."""
    at = dict(name="tp2_slam_f32", shape=[10, 7, 1, 1024, 64], ms=0.09, plain_ms=2.1,
              device_ms=0.08, plain_device_ms=2.0, bound_ms=0.02, bound_by="operations",
              cuda_core_bound_ms=0.05, library_ms=0.6, library="sdpa memory-efficient, graph",
              roofline_share=0.25, vs_library=0.13, max_abs_err_out=1e-6)
    entry = chip_smoke.shape_entry(at)
    assert entry["shape"] == [10, 7, 1, 1024, 64] and entry["max_abs_err"] == 1e-6
    assert (entry["graph_ms"], entry["plain_graph_ms"], entry["ms"]) == (0.08, 2.0, 0.09)
    assert (entry["bound_ms"], entry["cuda_core_bound_ms"], entry["library_ms"]) == (
        0.02, 0.05, 0.6)
    assert entry["library_timed"].startswith("sdpa") and entry["vs_library"] == 0.13


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
