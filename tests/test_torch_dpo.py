"""The port's DPO stage against the JAX package's, in float32 on the CPU: the
copies (`tokenize_row`, `calc_auto_bleu`, the repetition filter and
`init_preference_optimization_dataset` on both of its word-splitting
branches), the batches (`_collate`, `_bucket_lens`) bit for bit, the DPO
loss, its four reward metrics and every gradient against the JAX `dpo_loss`
under `jax.grad`, three trainer steps against the JAX SLAMDPOTrainer on a
one-device mesh, then the JAX trainer's own gates on the port: resume bit for
bit (also across an epoch boundary) with the reference still the initial
model, the evaluation's wrap-round, and the refusals.

Model: pythia-14m's shape cut to 2 layers (the JAX tests' model), float32,
the same weights in both packages through `models/convert.py`.

Tolerances: the loss 1e-5 relative and every gradient 1e-4 absolute and
relative (as `test_torch_training.py`): a float32 two-layer forward and
backward whose sums run in another order. The trainer's stream 1e-4
relative, 1e-6 absolute for the rewards near 0 (three steps of AdamW on
those gradients). The port against itself: bit for bit (same ops, same
order, on the CPU).
"""
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slamkit_tpu.config import compose as jax_compose
from slamkit_tpu.data import preference as jax_preference
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten, _unflatten
from slamkit_tpu.tokeniser.unit_tokeniser import UnitTokeniser as JaxUnitTokeniser
from slamkit_tpu.trainer.slam_dpo_trainer import SLAMDPOTrainer as JaxSLAMDPOTrainer
from slamkit_tpu.trainer.slam_dpo_trainer import tokenize_row as jax_tokenize_row
from slamkit_tpu.utils.calculation_utils import calc_auto_bleu as jax_calc_auto_bleu
from slamkit_tpu_torch.config import compose
from slamkit_tpu_torch.data import preference
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, grads_to_flat, to_flat
from slamkit_tpu_torch.tokeniser import UnitTokeniser
from slamkit_tpu_torch.trainer import SLAMDPOTrainer, TrainerCallback, tokenize_row
from slamkit_tpu_torch.utils.calculation_utils import calc_auto_bleu

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
            torch_dtype="float32", config_overrides=dict(num_hidden_layers=2))
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def unit_str(ids):
    return "".join(f"<Un{i}>" for i in ids)


def pref_rows(n, seed, as_dicts=False):
    """Preference rows over 60 units with ragged prompts and completions."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n):
        p, c, r = (rng.integers(0, 60, int(rng.integers(lo, hi)))
                   for lo, hi in ((3, 12), (2, 9), (2, 9)))
        if as_dicts:
            rows.append({k: {"units": v.tolist(), "duration": [1] * len(v)}
                         for k, v in (("prompt", p), ("chosen", c), ("rejected", r))})
        else:
            rows.append({"prompt": unit_str(p), "chosen": unit_str(c),
                         "rejected": unit_str(r)})
    return rows


def args_for(out, config_dir=REPO_ROOT / "config", jax_side=False, **overrides):
    """preference_alignment_train.yaml's training_args (dpo_training_args)."""
    ov = [f"training_args.output_dir={out}", "training_args.per_device_train_batch_size=4",
          "training_args.logging_steps=1", "training_args.max_steps=3",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    return (jax_compose if jax_side else compose)(str(config_dir), "preference_alignment_train",
                                                 ov).training_args


@pytest.fixture(scope="module")
def flat():
    return _flatten(JaxUnitLM(JaxUnitLMConfig(**TINY), seed=0).params)


def port_model(flat):
    return UnitLM(UnitLMConfig(**TINY), params=flat, device="cpu")


def jax_trainer(flat, rows, args, eval_rows=None):
    model = JaxUnitLM(JaxUnitLMConfig(**TINY), params=_unflatten(flat))
    return JaxSLAMDPOTrainer(model, JaxUnitTokeniser(load_fe=False, num_units=60), args, rows,
                             eval_dataset=eval_rows,
                             mesh=Mesh(np.array(jax.devices()[:1]), ("data",)))


# --------------------------------------------------------------------------- #
# the copies
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("max_prompt,max_completion", [(None, None), (4, 3), (2, 1)])
@pytest.mark.parametrize("as_dicts", [False, True])
def test_tokenize_row_equals_jax(max_prompt, max_completion, as_dicts):
    port, ref = UnitTokeniser(num_units=60), JaxUnitTokeniser(load_fe=False, num_units=60)
    for row in pref_rows(6, seed=1, as_dicts=as_dicts):
        got = tokenize_row(row, port, max_prompt, max_completion, add_special_tokens=False)
        want = jax_tokenize_row(row, ref, max_prompt, max_completion, add_special_tokens=False)
        assert got == want


TEXTS = ["", "one", "a b a b a b", "the cat sat on the mat and the cat sat",
         "hello, world. hello, there!", "so so so, it's fine; it's fine."]


@pytest.mark.parametrize("n", [1, 2, 3])
def test_calc_auto_bleu_equals_jax(n):
    for text in TEXTS:
        for tok in (jax_preference._WhitespaceTokenizer(), None):
            assert calc_auto_bleu(text, tok, n) == jax_calc_auto_bleu(text, tok, n), text


def _block_nltk(monkeypatch):
    """`from nltk.tokenize import ...` raises ImportError on both sides."""
    monkeypatch.setitem(sys.modules, "nltk", None)
    monkeypatch.setitem(sys.modules, "nltk.tokenize", None)


# prompt_text / chosen_text pairs; the first one's verdict depends on the
# word splitter: NLTK splits off the commas, and "hi ," repeats (auto-BLEU
# 2/6), where a whitespace split repeats no bigram
FILTER_ROWS = [("hi, there,", "hi, you"), ("a b c", "d e f"),
               ("a b a b", "a b a b a b"), ("x, y. x, y.", "z, z.")]


# The port splits words with its copy of NLTK's tokenizer on every host; the
# JAX package falls back to a whitespace split where nltk is missing. The
# branch names the host: "whitespace" blocks nltk on both sides, and the port
# must still give the JAX filter's verdicts with nltk installed (computed
# before the block), not the fallback's.
@pytest.mark.parametrize("branch", ["nltk", "whitespace"])
def test_repetition_filter_equals_jax_on_both_branches(monkeypatch, branch):
    pytest.importorskip("nltk")
    rows = [{"prompt_text": p, "chosen_text": c} for p, c in FILTER_ROWS]
    want = [jax_preference.get_repetition_filter_fn(2, 0.3)(r) for r in rows]
    if branch == "whitespace":
        fallback = jax_preference._WhitespaceTokenizer()
        assert calc_auto_bleu("hi, there, hi, you", fallback, 2) < 0.3 <= \
            calc_auto_bleu("hi, there, hi, you", preference.NLTKWordTokenizer(), 2)
        _block_nltk(monkeypatch)
    got = [preference.get_repetition_filter_fn(2, 0.3)(r) for r in rows]
    assert got == want
    # NLTK's verdicts on either host: the first row repeats "hi ,"
    assert got[:3] == [False, True, False]


@pytest.mark.parametrize("branch", ["nltk", "whitespace"])
def test_init_preference_dataset_equals_jax(tmp_path, monkeypatch, branch):
    pytest.importorskip("nltk")
    rows = pref_rows(len(FILTER_ROWS), seed=2, as_dicts=True)
    for r, (p, c) in zip(rows, FILTER_ROWS):
        r.update(prompt_text=p, chosen_text=c, extra=1)
    with open(tmp_path / "p.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    ov = [f"data.train_path={tmp_path}/p.jsonl", f"data.val_path={tmp_path}/p.jsonl"]
    want = jax_preference.init_preference_optimization_dataset(
        jax_compose(str(REPO_ROOT / "config"), "preference_alignment_train", ov).data)
    if branch == "whitespace":
        _block_nltk(monkeypatch)
    got = preference.init_preference_optimization_dataset(
        compose(str(REPO_ROOT / "config"), "preference_alignment_train", ov).data)
    assert got == want
    assert len(got["train"]) == 1
    assert set(got["validation"][0]) == {"prompt", "chosen", "rejected"}


# --------------------------------------------------------------------------- #
# batches, loss and gradients
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("buckets", [1, 3])
def test_collate_and_buckets_equal_jax(tmp_path, flat, buckets):
    rows, evals = pref_rows(24, seed=3), pref_rows(6, seed=4)
    ref = jax_trainer(flat, rows, args_for(tmp_path, jax_side=True, length_buckets=buckets),
                      evals)
    port = SLAMDPOTrainer(port_model(flat), UnitTokeniser(num_units=60),
                          args_for(tmp_path, length_buckets=buckets), rows, eval_dataset=evals)
    assert port.bucket_lens == ref.bucket_lens and port.bucket_lens[-1] == port.max_len
    assert (len(port.bucket_lens) > 1) == (buckets > 1)
    assert port.train_rows == ref.train_rows and port.eval_rows == ref.eval_rows
    assert (port.total_steps, port.steps_per_epoch) == (ref.total_steps, ref.steps_per_epoch)
    for start in range(0, 24, 4):
        got = port._collate(port.train_rows[start:start + 4])
        want = ref._collate(ref.train_rows[start:start + 4])
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _jax_dpo_loss(trainer):
    """The JAX trainer's own `dpo_loss` (the closure its jitted eval calls)."""
    fn = trainer._eval_loss.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells["dpo_loss"].cell_contents


def test_dpo_loss_metrics_and_gradients_equal_jax(tmp_path, flat):
    """A policy one AdamW step away from the reference (so the margins are
    not 0): loss, the four rewards and every gradient against jax.grad."""
    rows = pref_rows(8, seed=5)
    ref = jax_trainer(flat, rows, args_for(tmp_path, jax_side=True))
    port = SLAMDPOTrainer(port_model(flat), UnitTokeniser(num_units=60), args_for(tmp_path),
                          rows)
    # move the policy: the same perturbation on both sides, the reference stays
    rng = np.random.default_rng(6)
    moved = {k: (v + 0.02 * rng.standard_normal(v.shape)).astype(v.dtype)
             for k, v in flat.items()}
    port_policy = port_model(moved)
    port.model.decoder.load_state_dict(port_policy.decoder.state_dict())
    jax_params = _unflatten(moved)
    batch = port._collate(port.train_rows[:4])
    loss, metrics = port.dpo_loss(port._to_device(batch))
    loss.backward()
    dpo_loss = _jax_dpo_loss(ref)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    (want_loss, want_metrics), grads = jax.value_and_grad(
        lambda p: dpo_loss(p, ref.ref_params, jb), has_aux=True)(jax_params)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert abs(loss.item() - np.log(2)) > 1e-3        # the margins are not 0
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(want_metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    got, want = grads_to_flat(port.model.decoder), _flatten(grads)
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **GRAD_TOL, err_msg=k)
    # the reference took no gradient and still holds the initial weights
    for name, p in port.ref_decoder.named_parameters():
        assert p.grad is None and not p.requires_grad
    for k, v in to_flat(port.ref_decoder).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
STREAM_KEYS = ("loss", "rewards/chosen", "rewards/rejected", "rewards/accuracies",
               "rewards/margins", "learning_rate")


def test_three_steps_equal_jax_trainer(tmp_path, flat):
    """Three steps (warmup 0, lr 1e-3 so the rewards move) and the final
    evaluation over 5 rows wrapped round to two batches of 4."""
    rows, evals = pref_rows(16, seed=7), pref_rows(5, seed=8)
    over = dict(warmup_steps=0, warmup_ratio=0.0, learning_rate=1e-3, save_steps=0,
                async_save="false")
    want = jax_trainer(flat, rows, args_for(tmp_path / "jax", jax_side=True, **over),
                       evals).train()
    got = SLAMDPOTrainer(port_model(flat), UnitTokeniser(num_units=60),
                         args_for(tmp_path / "port", **over), rows, eval_dataset=evals).train()
    pick = lambda st, key: [r[key] for r in st.log_history if key in r]
    assert got.global_step == want.global_step == 3
    for key in STREAM_KEYS + ("eval_loss", "eval_rewards/accuracies"):
        assert len(pick(got, key)) == len(pick(want, key)) > 0, key
        np.testing.assert_allclose(pick(got, key), pick(want, key), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    assert pick(got, "loss")[0] == pytest.approx(np.log(2), abs=1e-6)
    assert got.epoch == want.epoch
    # the export loads in the JAX package
    back = JaxUnitLM.from_pretrained(str(tmp_path / "port" / "checkpoint-3"))
    assert sorted(_flatten(back.params)) == sorted(flat)


class StopAt(TrainerCallback):
    def __init__(self, step):
        self.step = step

    def on_step_end(self, args, state, control, **kw):
        if state.global_step >= self.step:
            control.should_training_stop = True


@pytest.mark.parametrize("n_rows,stop_at", [(32, 2), (12, 4)])
def test_resume_is_exact(tmp_path, flat, n_rows, stop_at):
    """A run stopped at `stop_at` and resumed from its checkpoint ends with the
    straight run's parameters, losses and optimizer state, bit for bit. 12
    rows are 3 batches an epoch, so the second case resumes past an epoch
    boundary (epoch 1.333). The resumed trainer's reference is the model it
    was built from."""
    rows = pref_rows(n_rows, seed=9)
    over = dict(max_steps=6, learning_rate=1e-3, warmup_steps=0, warmup_ratio=0.0)

    def run(out, resume=None, stop=None):
        tr = SLAMDPOTrainer(port_model(flat), UnitTokeniser(num_units=60),
                            args_for(out, **over), rows,
                            callbacks=[StopAt(stop)] if stop else [])
        state = tr.train(resume_from_checkpoint=resume)
        return tr, [r["loss"] for r in state.log_history if "loss" in r]

    straight, losses = run(tmp_path / "a")
    stopped, _ = run(tmp_path / "b", stop=stop_at)
    ckpt = tmp_path / "b" / f"checkpoint-{stop_at}"
    saved = json.loads((ckpt / "trainer_state.json").read_text())
    assert saved["global_step"] == stop_at and saved["epoch"] == stopped.state.epoch
    if n_rows == 12:
        assert int(saved["epoch"]) == 1 and saved["epoch"] > 1
    resumed, resumed_losses = run(tmp_path / "c", resume=str(ckpt))
    assert resumed.state.global_step == 6 and resumed_losses == losses
    assert resumed.state.epoch == straight.state.epoch
    for (k, a), b in zip(straight.model.decoder.named_parameters(),
                         resumed.model.decoder.parameters()):
        assert torch.equal(a, b), k
    for a, b in zip(straight.optimizer.exp_avg_sq, resumed.optimizer.exp_avg_sq):
        assert torch.equal(a, b)
    for k, v in to_flat(resumed.ref_decoder).items():
        np.testing.assert_array_equal(v, flat[k], err_msg=k)


def test_resume_from_latest_and_off_grid_saves(tmp_path, flat):
    """cont_training=true picks the newest checkpoint; saves keep to their
    due multiples after an off-grid resume."""
    rows = pref_rows(16, seed=10)
    base = dict(max_steps=5, save_steps=2, async_save="false")

    def run(resume=None, stop=None, **extra):
        tr = SLAMDPOTrainer(port_model(flat), UnitTokeniser(num_units=60),
                            args_for(tmp_path, **base, **extra), rows,
                            callbacks=[StopAt(stop)] if stop else [])
        return tr.train(resume_from_checkpoint=resume)

    run(stop=3)             # saves at 2, then the final save at 3
    state = run(resume=True)
    assert state.global_step == 5
    steps = sorted(int(d.name.split("-")[1]) for d in tmp_path.iterdir()
                   if d.name.startswith("checkpoint-"))
    assert steps == [4, 5]  # 3 -> the next due multiple 4, then the final 5 (limit 2)


def test_evaluate_wraps_round(tmp_path, flat):
    """3 eval rows with a batch of 8 are scored as (rows x 3)[:8], 5 rows with
    a batch of 4 as rows + rows[:3]."""
    rows = pref_rows(8, seed=11)
    for n_eval, bsz, want_rows in ((3, 8, lambda e: (e * 3)[:8]),
                                   (5, 4, lambda e: e + e[:3])):
        evals = pref_rows(n_eval, seed=12)
        tr = SLAMDPOTrainer(port_model(flat), UnitTokeniser(num_units=60),
                            args_for(tmp_path, per_device_train_batch_size=bsz), rows,
                            eval_dataset=evals)
        seen = []
        collate = tr._collate
        tr._collate = lambda r: seen.extend(r) or collate(r)
        out = tr.evaluate()
        assert seen == want_rows(tr.eval_rows)
        assert out["eval_loss"] == pytest.approx(np.log(2), abs=1e-6)
        assert out["eval_rewards/accuracies"] == 0.0


@pytest.mark.parametrize("override,match", [
    (dict(fsdp="true"), "item 14"),
    (dict(mesh_shape="[2]"), "item 14"),
    (dict(mesh_axes="[data,seq]"), "item 14"),
    (dict(multihost="true"), "item 14"),
])
def test_refuses_what_is_not_ported(tmp_path, flat, override, match):
    with pytest.raises(NotImplementedError, match=match):
        SLAMDPOTrainer(port_model(flat), UnitTokeniser(num_units=60),
                       args_for(tmp_path, **override), pref_rows(4, seed=0))


def test_refuses_a_model_with_dropout():
    with pytest.raises(ValueError, match="item 6"):
        UnitLM(UnitLMConfig(**{**TINY, "dropout": 0.1}), device="cpu")
