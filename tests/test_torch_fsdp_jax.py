"""Parameters sharded over 'data' (fsdp, ZeRO-3; `parallel/fsdp.py`) on gloo
ranks on the CPU, against the JAX package's trainers, one process, and the
unsharded evaluation.

  * The port's fsdp [2] losses and eval losses equal the JAX `SLAMTrainer`
    with `fsdp=true` on a 2-device mesh of the suite's CPU devices, from the
    same weights, within 1e-4 relative (dropout 0, JAX on its plain
    attention), under AdamW and under Adafactor at 128 wide with a sharded
    factored dim and clipping on (the block RMS of JAX's stacked leaves:
    `Adafactor(names=)`); the same for `SLAMDPOTrainer` against the JAX one,
    whose fsdp [2] run also equals one process within 1e-5 (losses, reward
    metrics, gradients, parameters) and resumes exactly.
  * Evaluation: `UnitLM.shard(mesh, fsdp=True)` on 2 and 3 ranks (3: weights
    no dim divides, pad-sharded) gives the one-process scores within 1e-6
    and its greedy, int8 greedy, sampled and penalised tokens; a bf16
    decoder run with `cast_weights` (the sharded generation path) equals
    `compute_copy`'s forward and greedy tokens bit for bit.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from slamkit_tpu.config import compose, to_container
from slamkit_tpu.data.dataset import TokenDataset as JaxTokenDataset
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu.trainer import SLAMTrainer as JaxSLAMTrainer
from slamkit_tpu.trainer.slam_dpo_trainer import SLAMDPOTrainer as JaxSLAMDPOTrainer
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
from slamkit_tpu_torch.tokeniser import UnitTokeniser
from slamkit_tpu_torch.trainer import SLAMDPOTrainer

import torch_mesh_workers
from torch_fsdp_cases import (CONFIG, CONTEXT, EVAL, GLOBAL_ROWS, REPO_ROOT, TRAIN, WIDE,
                              save_params, train_args)
from torch_mesh_workers import DPO_KEYS

torch.set_num_threads(1)


def _jax_args_node(out, **overrides):
    """The JAX composer's training_args of `torch_fsdp_cases.args_node`."""
    ov = [f"training_args.output_dir={out}", "training_args.max_steps=2",
          "training_args.gradient_accumulation_steps=2", "training_args.logging_steps=1",
          "training_args.save_steps=1", "training_args.eval_strategy=steps",
          "training_args.eval_steps=1", "training_args.async_save=false",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    return compose(str(REPO_ROOT / "config"), "train", ov).training_args


@pytest.mark.parametrize("optim", ["adamw_torch", "adafactor"])
def test_fsdp_losses_match_the_jax_trainer_on_two_devices(tmp_path, optim):
    """The port's fsdp [2] run and the JAX SLAMTrainer with fsdp=true on a
    2-device CPU mesh (attn xla), same weights and global batch, dropout 0;
    Adafactor at 128 wide with max_grad_norm 0.05 (clipping on)."""
    overrides = {"config_overrides": WIDE} if optim == "adafactor" else {}
    cfg = {**CONFIG, "dropout": 0.0, **overrides}
    extra = dict(optim=optim, max_grad_norm="0.05") if optim == "adafactor" else {}
    jax_model = JaxUnitLM(JaxUnitLMConfig(**{**cfg, "attn_implementation": "xla"}), seed=0)
    flat = _flatten(jax_model.params)
    per_device = dict(per_device_train_batch_size=GLOBAL_ROWS // 2,
                      per_device_eval_batch_size=GLOBAL_ROWS // 2)
    want = JaxSLAMTrainer(jax_model, _jax_args_node(tmp_path / "jax", fsdp="true", **per_device,
                                                **extra),
                          JaxTokenDataset.from_lists(TRAIN),
                          eval_dataset=JaxTokenDataset.from_lists(EVAL), packing=True,
                          context_len=CONTEXT,
                          mesh=JaxMesh(np.array(jax.devices()[:2]), ("data",))
                          ).train().log_history
    args = train_args(tmp_path / "mesh", fsdp="true", mesh_shape="[2]", **per_device, **extra)
    got = torch_mesh_workers.launch("train", 2, tmp_path / "ranks", config=cfg, args=args,
                                    train_seqs=TRAIN, eval_seqs=EVAL, context_len=CONTEXT,
                                    params_path=save_params(tmp_path, flat))
    want_loss = [r["loss"] for r in want if "loss" in r]
    want_eval = [r["eval_loss"] for r in want if "eval_loss" in r]
    assert len(want_loss) == 2 and len(want_eval) == 2
    for rank in got:
        np.testing.assert_allclose(rank["a/loss"], want_loss, rtol=1e-4)
        np.testing.assert_allclose(rank["a/eval_loss"], want_eval, rtol=1e-4)


# --------------------------------------------------------------------------- #
# DPO
# --------------------------------------------------------------------------- #
DPO_CONFIG = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
                  torch_dtype="float32", dropout=0.1, config_overrides=dict(num_hidden_layers=2))
GLOBAL_PAIRS = 4


def pref_rows(n, seed):
    rng = np.random.default_rng(seed)
    unit = lambda ids: "".join(f"<Un{i}>" for i in ids)
    return [{k: unit(rng.integers(0, 60, int(rng.integers(lo, hi))))
             for k, (lo, hi) in (("prompt", (3, 30)), ("chosen", (2, 20)),
                                 ("rejected", (2, 20)))} for _ in range(n)]


DPO_TRAIN, DPO_EVAL = pref_rows(16, seed=0), pref_rows(6, seed=1)


def _dpo_args(out, jax_side=False, **overrides):
    ov = [f"training_args.output_dir={out}", "training_args.max_steps=2",
          "training_args.logging_steps=1", "training_args.save_steps=1",
          "training_args.async_save=false", "training_args.length_buckets=2",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    node = compose(str(REPO_ROOT / "config"), "preference_alignment_train", ov).training_args
    return node if jax_side else to_container(node)


def test_fsdp_dpo_equals_one_process_and_resumes_exactly(tmp_path):
    args = _dpo_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_PAIRS // 2,
                     mesh_shape="[2]", fsdp="true")
    got = torch_mesh_workers.launch("dpo", 2, tmp_path / "ranks", config=DPO_CONFIG,
                                    args=args, train_rows=DPO_TRAIN, eval_rows=DPO_EVAL)
    model = UnitLM(UnitLMConfig(**DPO_CONFIG), seed=0, device="cpu")
    tr = SLAMDPOTrainer(model, UnitTokeniser(num_units=60),
                        _dpo_args(tmp_path / "one", per_device_train_batch_size=GLOBAL_PAIRS),
                        DPO_TRAIN, eval_dataset=DPO_EVAL)
    want_grads = torch_mesh_workers.record_grads(tr)
    history = tr.train().log_history
    want = {key: [r[key] for r in history if key in r] for key in DPO_KEYS}
    want_params = to_flat(model.decoder)
    for rank in got:
        for key in DPO_KEYS:
            np.testing.assert_allclose(rank[f"a/{key}"], want[key], rtol=1e-5, atol=1e-5,
                                       err_msg=key)
            np.testing.assert_array_equal(rank[f"b/{key}"], rank[f"a/{key}"], err_msg=key)
        for i, grads in enumerate(want_grads):
            for k, g in grads.items():
                np.testing.assert_allclose(rank[f"a/grad{i}/{k}"], g, rtol=0,
                                           atol=1e-5 * np.abs(g).max(), err_msg=f"{k} step {i}")
        for k, v in want_params.items():
            np.testing.assert_allclose(rank[f"a/param/{k}"], v, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_array_equal(rank[f"b/param/{k}"], rank[f"a/param/{k}"],
                                          err_msg=k)


def test_fsdp_dpo_matches_the_jax_trainer_on_two_devices(tmp_path):
    cfg = {**DPO_CONFIG, "dropout": 0.0}
    jax_model = JaxUnitLM(JaxUnitLMConfig(**cfg), seed=0)
    flat = _flatten(jax_model.params)
    want = JaxSLAMDPOTrainer(
        jax_model, JaxUnitTokeniser(load_fe=False, num_units=60),
        _dpo_args(tmp_path / "jax", jax_side=True, fsdp="true",
                  per_device_train_batch_size=GLOBAL_PAIRS // 2),
        DPO_TRAIN, eval_dataset=DPO_EVAL,
        mesh=JaxMesh(np.array(jax.devices()[:2]), ("data",))).train().log_history
    args = _dpo_args(tmp_path / "mesh", per_device_train_batch_size=GLOBAL_PAIRS // 2,
                     mesh_shape="[2]", fsdp="true")
    got = torch_mesh_workers.launch("dpo", 2, tmp_path / "ranks", config=cfg, args=args,
                                    train_rows=DPO_TRAIN, eval_rows=DPO_EVAL,
                                    params_path=save_params(tmp_path, flat))
    for key in DPO_KEYS:
        np.testing.assert_allclose(got[0][f"a/{key}"], [r[key] for r in want if key in r],
                                   rtol=1e-4, atol=1e-6, err_msg=key)


# --------------------------------------------------------------------------- #
# evaluation
# --------------------------------------------------------------------------- #
TINY_LM = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=502, twist_init=False,
               torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))


def _eval_batches(seed=0, n=5):
    rng = np.random.default_rng(seed)
    tokens = np.zeros((n, 90), np.int32)
    prompts = np.zeros((n, 12), np.int32)
    for i in range(n):
        k = int(rng.integers(20, 91))
        tokens[i, :k] = rng.integers(2, 502, k)
        p = int(rng.integers(3, 13))
        prompts[i, 12 - p:] = rng.integers(2, 502, p)
    return tokens, prompts


@pytest.mark.parametrize("ranks", [2, 3])
def test_fsdp_eval_equals_one_process(tmp_path, ranks):
    ckpt = tmp_path / "ckpt"
    UnitLM(UnitLMConfig(**TINY_LM), seed=0, device="cpu").save_pretrained(str(ckpt))
    tokens, prompts = _eval_batches()
    got = torch_mesh_workers.launch("eval_mesh", ranks, tmp_path / "ranks", ckpt=str(ckpt),
                                    tokens=tokens.tolist(), prompts=prompts.tolist(), fsdp=True)
    want = torch_mesh_workers.eval_calls(UnitLM.from_pretrained(str(ckpt), device="cpu"),
                                         tokens, prompts, int8=True)
    for rank in got:
        assert sorted(rank) == sorted(want)
        for k in ("ll", "ll_sum", "ll_ignore"):
            np.testing.assert_allclose(rank[k], want[k], rtol=0, atol=1e-6, err_msg=k)
        for k in ("greedy", "int8", "sampled", "penalised"):
            np.testing.assert_array_equal(rank[k], want[k], err_msg=k)


def test_cast_weights_is_compute_copy_in_bf16():
    """The sharded generation path's weights (`Decoder.forward(cast_weights=
    True)`, each cast at its use) are `compute_copy`'s: bf16 logits and
    greedy tokens bit for bit."""
    import importlib

    gen = importlib.import_module("slamkit_tpu_torch.models.generate")

    cfg = {**TINY_LM, "torch_dtype": "bfloat16"}
    tlm = UnitLM(UnitLMConfig(**cfg), seed=0, device="cpu")
    tokens, prompts = _eval_batches(seed=2)
    ids = torch.from_numpy(tokens).long()
    with torch.inference_mode():
        want, _ = gen.compute_copy(tlm.decoder)(ids)
        got, _ = tlm.decoder(ids, cast_weights=True)
        plain, _ = tlm.decoder(ids)
    assert torch.equal(got, want)
    assert not torch.equal(plain, want)   # the cast matters: the head is rounded
    want_tokens = tlm.generate(prompts, max_new_tokens=8, do_sample=False)
    sharded = gen.is_sharded
    gen.is_sharded = lambda decoder: True   # the path a sharded decoder takes
    try:
        got_tokens = tlm.generate(prompts, max_new_tokens=8, do_sample=False)
    finally:
        gen.is_sharded = sharded
    assert torch.equal(got_tokens, want_tokens)
