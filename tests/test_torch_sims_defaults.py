"""SIMS at its shipped defaults on the port against the JAX package, on the
CPU: `cli.train --config-name train_inter_scale` on the two base models the
shipped configs name, through the text tokenisers they ship with.

  * pythia-14m (config/train_inter_scale.yaml's base) at its full width (6
    layers, 128 wide, 4 heads of 32, untied head) from
    `sims_recipe.write_pythia14m_base`, whose GPT-NeoX-shaped tokenizer.json
    (50277 ids) is also the text tokeniser: 50779 ids with the units;
  * train.yaml's default model, facebook/opt-125m (config/model/default.yaml,
    also config/tokeniser/interleaved_hubert_25.yaml's text tokeniser) at its
    published width, cut to 2 layers: `sims_recipe.write_opt125m_base`, its
    config.json beside GPT-2 vocab.json + merges.txt files and no
    tokenizer.json (50265 ids, 50767 with the units).

`cli.train` reads the interleaving tokeniser from the base model's directory
(both packages replace `tokeniser.params.text_tokeniser_path` by
`model.config_args.base_model_name`), so each directory is both.

Each trains 3 steps at context 128 from one JAX-written float32 checkpoint
over three seeded corpora (text, interleaved, speech), with an eval at step
3 and the token accounting restricted to the unit ids, as
test_torch_sims.py::test_train_cli_on_train_inter_scale_matches_jax does:
losses and eval losses within 1e-4 relative, learning rates 1e-6, the token
counts equal. The JAX CLI runs on the suite's 8 virtual devices, so its
per-device batch of 1 is the port's 8. The JAX side takes the plain
attention (its Pallas kernel would run in interpret mode); the port's
flash_attention_2 is the plain attention on the CPU.
"""
import importlib.util
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from slamkit_tpu_torch.tokeniser.text_tokeniser import TextTokeniser
from slamkit_tpu_torch.tools import sims_recipe

pytest.importorskip("transformers")
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
N_WORDS = 60


def _jax_cli(name: str):
    mod_name = f"_jax_cli_{name}"
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(mod_name, REPO_ROOT / "cli" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    d = tmp_path_factory.mktemp("sims_defaults")
    (d / "train").mkdir()
    (d / "val").mkdir()
    sims_recipe.write_corpora(d / "train", 24, lengths=(20, 160), n_words=N_WORDS)
    sims_recipe.write_corpora(d / "val", 3, lengths=(20, 100), n_words=N_WORDS, seed=1)
    return d


def _base(kind, root):
    """(the base directory, the checkpoint's decoder overrides)."""
    if kind == "pythia14m":
        return sims_recipe.write_pythia14m_base(root / "pythia"), {}
    return sims_recipe.write_opt125m_base(root / "opt"), dict(num_hidden_layers=2)


def _overrides(corpora, base, ckpt, out, per_device, n_text, **extra):
    split = lambda s: ",".join(str(corpora / s / f"{n}.jsonl")
                               for n in ("text", "inter", "speech"))
    ov = {"data.train_path": f"[{split('train')}]", "data.val_path": f"[{split('val')}]",
          "model.pretrained_model": ckpt, "model.context_len": 128,
          "model.config_args.base_model_name": base,
          "tokeniser.params.text_tokeniser_path": base,
          "model.config_args.twist_init": "false", "model.config_args.torch_dtype": "float32",
          "logger": "print", "training_args.output_dir": out, "training_args.max_steps": 3,
          "training_args.per_device_train_batch_size": per_device,
          "training_args.per_device_eval_batch_size": per_device,
          "training_args.logging_steps": 1, "training_args.save_steps": 3,
          "training_args.eval_steps": 3, "training_args.warmup_steps": 1,
          "training_args.min_token_id_count": n_text,
          "training_args.max_token_id_count": n_text + 499, **extra}
    return ["--config-name", "train_inter_scale"] + [f"{k}={v}" for k, v in ov.items()]


def _logged(out, key):
    history = json.loads((pathlib.Path(out) / "checkpoint-3" /
                          "trainer_state.json").read_text())["log_history"]
    return [r[key] for r in history if key in r]


@pytest.mark.parametrize("kind", ["pythia14m", "opt125m_bpe_files"])
def test_train_inter_scale_at_the_shipped_bases_matches_jax(corpora, tmp_path, kind):
    from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
    from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
    from slamkit_tpu_torch.cli import train as port_train
    from slamkit_tpu_torch.models import UnitLM

    base, cut = _base(kind, tmp_path)
    n_text = len(TextTokeniser.from_pretrained(base))
    assert n_text == (sims_recipe.NEOX_VOCAB if kind == "pythia14m" else sims_recipe.OPT_VOCAB)
    vocab = n_text + 502
    ckpt = tmp_path / "ckpt"
    JaxUnitLM(JaxUnitLMConfig(base_model_name=base, vocab_size=vocab, twist_init=False,
                              torch_dtype="float32", config_overrides=cut),
              seed=0).save_pretrained(str(ckpt))
    state = port_train.train(_overrides(corpora, base, ckpt, tmp_path / "port", 8, n_text,
                                        **{"training_args.use_cpu": "true"}))
    _jax_cli("train").train(_overrides(corpora, base, ckpt, tmp_path / "jax", 1, n_text,
                                       **{"model.config_args.attn_implementation": "null"}))
    got, want = tmp_path / "port", tmp_path / "jax"
    assert state.global_step == 3 and len(_logged(got, "loss")) == 3
    np.testing.assert_allclose(_logged(got, "loss"), _logged(want, "loss"), rtol=1e-4)
    np.testing.assert_allclose(_logged(got, "eval_loss"), _logged(want, "eval_loss"),
                               rtol=1e-4)
    np.testing.assert_allclose(_logged(got, "learning_rate"), _logged(want, "learning_rate"),
                               rtol=1e-6)
    seen = _logged(got, "num_input_tokens_seen")
    assert seen == _logged(want, "num_input_tokens_seen") and 0 < seen[0]
    saved = json.loads((got / "checkpoint-3" / "unit_lm_config.json").read_text())
    assert saved["vocab_size"] == vocab and saved["attn_implementation"] == "flash_attention_2"
    cfg = UnitLM.from_pretrained(str(got / "checkpoint-3"), device="cpu").decoder.cfg
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.head_dim) == (
        (128, 6, 4, 32) if kind == "pythia14m" else (768, 2, 12, 64))
