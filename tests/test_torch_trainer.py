"""The port's SLAMTrainer: the same losses as the JAX SLAMTrainer on the same
stream and weights (float32, one device), then the JAX trainer's own gates
(`tests/test_trainer.py`) on the port: accumulation equals one big batch,
resume equivalence (also across an epoch boundary), periodic saves after an
off-grid resume, async save equal to sync, token-id-range counting, the last
accumulation group flushed, incomplete checkpoints skipped, a changed
packing strategy refused, atomic host artifacts, exports the JAX package
loads, the profiler's trace, and the refusals of unported knobs.

Tolerances: losses 1e-4 relative against JAX (float32 forward, backward and
AdamW whose sums run in another order, over three steps); the port against
itself: resume and async/sync bit for bit (same ops, same order, on the CPU),
accumulation 2e-4 / 2e-5 as the JAX gate (the group's sum runs in another
order).
"""
import json
import os
import pathlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from slamkit_tpu.config import compose, to_container
from slamkit_tpu.data.dataset import TokenDataset as JaxTokenDataset
from slamkit_tpu.models.unit_lm import UnitLM as JaxUnitLM
from slamkit_tpu.models.unit_lm import UnitLMConfig as JaxUnitLMConfig
from slamkit_tpu.models.unit_lm import _flatten
from slamkit_tpu.trainer import SLAMTrainer as JaxSLAMTrainer
from slamkit_tpu_torch.data import TokenDataset
from slamkit_tpu_torch.models import UnitLM, UnitLMConfig, to_flat
from slamkit_tpu_torch.trainer import SLAMTrainer, TrainerCallback, checkpoint

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
            torch_dtype="float32")


def _args_node(out, **overrides):
    ov = [f"training_args.output_dir={out}",
          "training_args.per_device_train_batch_size=8",
          "training_args.max_steps=2",
          "training_args.logging_steps=1",
          "training_args.eval_strategy=no",
          "training_args.save_steps=0",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    return compose(str(REPO_ROOT / "config"), "train", ov).training_args


def train_args(out, **overrides) -> dict:
    """The composed training_args (default + pretrain yaml) as a plain dict."""
    return to_container(_args_node(out, **overrides))


def seqs(n=64, seed=0, vocab=64, min_len=5, max_len=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=rng.integers(min_len, max_len)).tolist()
            for _ in range(n)]


def tiny_dataset(n=64, seed=0):
    return TokenDataset.from_lists(seqs(n, seed))


def tiny_model(seed=0):
    return UnitLM(UnitLMConfig(**TINY), seed=seed, device="cpu")


def params_of(model):
    return {k: v.copy() for k, v in to_flat(model.decoder).items()}


class StopAt(TrainerCallback):
    def __init__(self, step):
        self.step = step

    def on_step_end(self, args, state, control, **kw):
        if state.global_step >= self.step:
            control.should_training_stop = True
            control.should_save = True


def test_losses_match_jax_trainer(tmp_path):
    """Three steps of accumulation 2 over best-fit-packed batches, then the
    eval: the JAX trainer on an explicit one-device mesh and the port on the
    same weights and stream log the same losses and token counts."""
    over = dict(gradient_accumulation_steps=2, per_device_train_batch_size=2, max_steps=3,
                warmup_steps=0, warmup_ratio=0.0, eval_strategy="steps", eval_steps=3)
    jax_model = JaxUnitLM(JaxUnitLMConfig(**TINY), seed=0)
    flat = _flatten(jax_model.params)
    train, evals = seqs(96), seqs(12, seed=1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    jax_tr = JaxSLAMTrainer(jax_model, _args_node(tmp_path / "jax", **over),
                            JaxTokenDataset.from_lists(train),
                            eval_dataset=JaxTokenDataset.from_lists(evals),
                            packing=True, context_len=32, mesh=mesh)
    want = jax_tr.train()
    tr = SLAMTrainer(UnitLM(UnitLMConfig(**TINY), params=flat, device="cpu"),
                     train_args(tmp_path / "port", **over), TokenDataset.from_lists(train),
                     eval_dataset=TokenDataset.from_lists(evals), packing=True, context_len=32)
    got = tr.train()
    pick = lambda st, key: [r[key] for r in st.log_history if key in r]
    assert len(pick(got, "loss")) == 3
    np.testing.assert_allclose(pick(got, "loss"), pick(want, "loss"), rtol=1e-4)
    np.testing.assert_allclose(pick(got, "eval_loss"), pick(want, "eval_loss"), rtol=1e-4)
    np.testing.assert_allclose(pick(got, "learning_rate"), pick(want, "learning_rate"),
                               rtol=1e-6)
    assert got.num_input_tokens_seen == want.num_input_tokens_seen > 0


@pytest.mark.parametrize("packing", [False, True])
def test_train_two_steps_and_export_loads_in_jax(tmp_path, packing):
    model = tiny_model()
    tr = SLAMTrainer(model, train_args(tmp_path / "out"), tiny_dataset(),
                     eval_dataset=tiny_dataset(8, seed=1), packing=packing, context_len=32)
    state = tr.train()
    assert state.global_step == 2 and state.num_input_tokens_seen > 0
    losses = [r["loss"] for r in state.log_history if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    ckpt = tmp_path / "out" / "checkpoint-2"
    assert (ckpt / "state").is_dir() and (ckpt / "trainer_state.json").is_file()
    back = JaxUnitLM.from_pretrained(str(ckpt))
    for k, v in params_of(model).items():
        np.testing.assert_array_equal(_flatten(back.params)[k], v, err_msg=k)
    assert UnitLM.from_pretrained(str(ckpt), device="cpu").decoder.cfg == model.decoder.cfg


def test_train_loss_decreases(tmp_path):
    rng = np.random.default_rng(0)
    cyclic = [[(2 + (s + i) % 4) for i in range(24)] for s in rng.integers(0, 4, 256)]
    args = train_args(tmp_path, max_steps=20, learning_rate=1e-3, warmup_steps=0,
                      warmup_ratio=0.0)
    state = SLAMTrainer(tiny_model(), args, TokenDataset.from_lists(cyclic),
                        context_len=32).train()
    losses = [r["loss"] for r in state.log_history if "loss" in r]
    assert losses[-1] < losses[0]


def test_grad_accum_matches_big_batch(tmp_path):
    ds = tiny_dataset(128)

    def run(accum, per_dev):
        model = tiny_model()
        args = train_args(tmp_path, gradient_accumulation_steps=accum,
                          per_device_train_batch_size=per_dev, max_steps=2)
        SLAMTrainer(model, args, ds, packing=True, context_len=32).train()
        return params_of(model)

    a, b = run(2, 4), run(1, 8)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=2e-5, err_msg=k)


def test_checkpoint_resume_equivalence(tmp_path):
    ds = tiny_dataset(128)

    def run(out, resume=False, stop_at=None):
        model = tiny_model()
        args = train_args(out, max_steps=4)
        SLAMTrainer(model, args, ds, callbacks=[StopAt(stop_at)] if stop_at else [],
                    context_len=32).train(resume_from_checkpoint=resume)
        return params_of(model)

    straight = run(tmp_path / "a")
    run(tmp_path / "b", stop_at=2)
    resumed = run(tmp_path / "b", resume=True)
    for k in straight:
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_resume_across_epoch_boundary(tmp_path):
    """24 rows / batch 8 = 3 microbatches an epoch with accumulation 2: the
    second group straddles the epoch roll, and checkpoint-1's resume point
    reaches back into epoch 0."""
    ds = tiny_dataset(24)

    def run(out, resume=False, save_steps=0):
        model = tiny_model()
        args = train_args(out, gradient_accumulation_steps=2, max_steps=2,
                          save_steps=save_steps)
        SLAMTrainer(model, args, ds, context_len=32).train(resume_from_checkpoint=resume)
        return params_of(model)

    straight = run(tmp_path / "a")
    saved = run(tmp_path / "b", save_steps=1)
    ckpt1 = tmp_path / "b" / "checkpoint-1"
    assert json.loads((ckpt1 / "trainer_state.json").read_text())["data_pos"] == [0, 2]
    resumed = run(tmp_path / "c", resume=str(ckpt1))
    for k in straight:
        np.testing.assert_array_equal(saved[k], straight[k], err_msg=k)
        np.testing.assert_array_equal(resumed[k], straight[k], err_msg=k)


def test_periodic_saves_after_offgrid_resume(tmp_path):
    ds = tiny_dataset(128)

    def run(resume=False, **ov):
        args = train_args(tmp_path / "out", gradient_accumulation_steps=2,
                          save_total_limit=100, **ov)
        SLAMTrainer(tiny_model(), args, ds, eval_dataset=tiny_dataset(8, seed=1),
                    packing=True, context_len=32).train(resume_from_checkpoint=resume)

    run(max_steps=3, save_steps=0)
    run(resume=True, max_steps=10, save_steps=4, eval_strategy="steps", eval_steps=4)
    have = sorted(int(p.name.split("-")[1]) for p in (tmp_path / "out").iterdir()
                  if p.name.startswith("checkpoint-"))
    assert have == [3, 4, 8, 10], have


def test_async_save_matches_sync(tmp_path):
    ds = tiny_dataset(128)

    def run(out, async_save):
        args = train_args(out, gradient_accumulation_steps=2, save_total_limit=100,
                          max_steps=3, save_steps=1, async_save=async_save)
        SLAMTrainer(tiny_model(), args, ds, packing=True, context_len=32).train()

    run(tmp_path / "a", async_save=True)
    run(tmp_path / "b", async_save=False)
    for step in (1, 2, 3):
        a = np.load(tmp_path / "a" / f"checkpoint-{step}" / "params.npz")
        b = np.load(tmp_path / "b" / f"checkpoint-{step}" / "params.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"step{step}:{k}")
        sa = checkpoint.load_state(str(tmp_path / "a" / f"checkpoint-{step}"), "cpu")
        sb = checkpoint.load_state(str(tmp_path / "b" / f"checkpoint-{step}"), "cpu")
        assert sa["step"] == sb["step"] == step
        for x, y in zip(sa["exp_avg"] + sa["exp_avg_sq"], sb["exp_avg"] + sb["exp_avg_sq"]):
            assert torch.equal(x, y)


def test_token_id_range_counting(tmp_path):
    ds = tiny_dataset()
    ranged = SLAMTrainer(tiny_model(), train_args(tmp_path, min_token_id_count=10,
                                                  max_token_id_count=20),
                         ds, context_len=32).train()
    full = SLAMTrainer(tiny_model(), train_args(tmp_path), ds, context_len=32).train()
    assert 0 < ranged.num_input_tokens_seen < full.num_input_tokens_seen


def test_last_group_flushes_on_epoch_budget(tmp_path):
    rng = np.random.default_rng(0)
    ds = TokenDataset.from_lists([rng.integers(2, 64, size=32).tolist() for _ in range(32)])
    args = train_args(tmp_path, gradient_accumulation_steps=2)
    args["max_steps"] = None
    args["num_train_epochs"] = 1
    tr = SLAMTrainer(tiny_model(), args, ds, context_len=32)
    assert tr.train().global_step == tr.total_steps == 2


def test_latest_checkpoint_skips_incomplete_dirs(tmp_path):
    def make(step, state=True, json_file=True):
        d = tmp_path / f"checkpoint-{step}"
        (d / "state").mkdir(parents=True) if state else d.mkdir(parents=True)
        if json_file:
            (d / "trainer_state.json").write_text("{}")

    make(100)
    make(200, json_file=False)      # killed mid-save
    make(300, state=False)          # host artifacts only
    got = checkpoint.latest_checkpoint(str(tmp_path))
    assert got and got.endswith("checkpoint-100")


def test_resume_rejects_changed_packing_strategy(tmp_path):
    ds = tiny_dataset(64)
    args = train_args(tmp_path, max_steps=2)
    SLAMTrainer(tiny_model(), args, ds, packing=True, context_len=32,
                packing_strategy="bestfit").train()
    tr = SLAMTrainer(tiny_model(), args, ds, packing=True, context_len=32,
                     packing_strategy="greedy")
    with pytest.raises(ValueError, match="packing_strategy"):
        tr.train(resume_from_checkpoint=True)


def test_save_host_artifacts_atomic_and_nonmutating(tmp_path):
    model = tiny_model()
    live = params_of(model)
    snap = checkpoint.snapshot({"params": dict(model.decoder.named_parameters())})
    with torch.no_grad():
        for p in snap["params"].values():
            p.zero_()
    checkpoint.save_host_artifacts(str(tmp_path), {"global_step": 3}, model, snap)
    assert json.loads((tmp_path / "trainer_state.json").read_text()) == {"global_step": 3}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    exported = np.load(tmp_path / "params.npz")
    assert all(np.all(exported[k] == 0) for k in exported.files)
    for k, v in params_of(model).items():
        np.testing.assert_array_equal(v, live[k])


@pytest.mark.parametrize("knob", [dict(fsdp="true"), dict(mesh_shape="[4,2]"),
                                  dict(mesh_axes="[data,seq]"), dict(cp_schedule="zigzag"),
                                  dict(multihost="true"), dict(optim="adafactor")])
def test_unported_knobs_raise(tmp_path, knob):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SLAMTrainer(tiny_model(), train_args(tmp_path, **knob), tiny_dataset(), context_len=32)


def test_profile_steps_write_a_trace(tmp_path):
    """profile_steps=2 from profile_start=1 traces steps 2 and 3 of four into
    <output_dir>/profile with the step's named ranges, and the run goes on."""
    import gzip

    args = train_args(tmp_path, max_steps=4, profile_steps=2, profile_start=1)
    state = SLAMTrainer(tiny_model(), args, tiny_dataset(), context_len=32).train()
    assert state.global_step == 4
    trace = tmp_path / "profile" / "trace.json.gz"
    events = json.loads(gzip.decompress(trace.read_bytes()))["traceEvents"]
    names = [e.get("name") for e in events]
    for span in ("train/forward", "train/backward", "train/optimizer"):
        assert names.count(span) == 2, span
