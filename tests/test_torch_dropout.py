"""The port's dropout, attention dropout, layerdrop and `remat_policy="qkv"`
against the JAX package's, in float32 on the CPU.

  * p = 0: rates named at 0, a seed at rate 0, or dropout without a seed give
    bit for bit the deterministic forward and gradients, under every remat
    policy.
  * Sites and scaling: the port draws its masks from its own generators
    (`jax.random` streams cannot be reproduced in torch), so here both sides
    take the same masks: JAX its own `jax.random.bernoulli` draws from the
    keys its `forward` splits, the port those arrays through a patched
    `transformer._keep_mask`; layerdrop skips layers 1 and 3 on both (JAX's
    scalar `bernoulli` patched to compare the key with those layers' keys,
    the port's `_layer_drops`). The loss and every gradient then agree, for
    pre-norm, parallel-residual and post-LN blocks, and for attention
    dropout through `attn_impl="xla"` (`mha_reference` on both sides).
  * The masks: the kept share, seeds and sites; bf16 scaling bit for bit
    as JAX's `_dropout`.
  * Remat: with the masks live, no remat, "full", "qkv" and partial remat
    give bitwise equal gradients; "qkv" runs `flash_attention` once a layer
    that is not skipped, "full" twice; a skipped layer's gradients are zeros.
  * The trainers: SLAMTrainer's dropout stream rides in its checkpoint and a
    resumed run repeats the straight run bit for bit, with a deterministic
    eval; DPO's dropout is live, seeded and resumes exactly; the flash path
    refuses attention dropout as JAX does; `cli.train` at the slice's
    overrides resumes exactly.

Tolerance against JAX: 1e-4 absolute and relative on the loss and every
gradient, as `tests/test_torch_training.py` (a float32 forward and backward
whose sums run in another order). The port against itself: bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slamkit_tpu.models import init_params as jax_init_params
from slamkit_tpu.models import transformer as jax_transformer
from slamkit_tpu.models.presets import resolve_base_config as jax_resolve
from slamkit_tpu.models.unit_lm import _flatten, _unflatten
from slamkit_tpu.utils.calculation_utils import cross_entropy_loss as jax_cross_entropy
from slamkit_tpu_torch.data import TokenDataset
from slamkit_tpu_torch.models import Decoder, UnitLM, UnitLMConfig, grads_to_flat, load_flat
from slamkit_tpu_torch.models import transformer
from slamkit_tpu_torch.models.presets import resolve_base_config
from slamkit_tpu_torch.trainer import SLAMDPOTrainer, SLAMTrainer, TrainerCallback
from slamkit_tpu_torch.utils.calculation_utils import cross_entropy_loss

# the gate runs several pytest workers on the CPU's cores: one torch thread
# each keeps their thread pools from oversubscribing the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-4, rtol=1e-4)
SMALL = dict(hidden_size=64, num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
             intermediate_size=128, vocab_size=96, max_position_embeddings=128,
             dtype="float32")
LAYOUTS = {
    "pre_norm": ("Qwen/Qwen2.5-0.5B", dict(rope_theta=10000.0)),
    "parallel_residual": ("EleutherAI/pythia-14m", dict(num_kv_heads=4)),
    # opt-350m: post-LN blocks, learned positions, project_in/out
    "post_ln": ("facebook/opt-125m", dict(num_kv_heads=4, pre_norm=False, embed_proj_dim=32)),
}
DROPPED = (1, 3)


def _configs(layout, **knobs):
    name, extra = LAYOUTS[layout]
    kw = {**SMALL, **extra, **knobs}
    return resolve_base_config(name, **kw), jax_resolve(name, **kw)


def _random_flat(jcfg, seed=0):
    shapes = {k: v.shape for k, v in
              _flatten(jax_init_params(jcfg, jax.random.PRNGKey(0))).items()}
    rng = np.random.default_rng(seed)
    flat = {}
    for k, shape in sorted(shapes.items()):
        x = rng.standard_normal(shape).astype(np.float32)
        flat[k] = (1.0 + 0.1 * x) if k.endswith("_scale") else 0.05 * x
    return flat


def _batch(vocab, seed=0):
    """Two rows of 40 in packed segments with per-segment positions, a -1
    tail, and labels off each segment's first token and the tail."""
    rng = np.random.default_rng(seed)
    seg = np.array([[0] * 15 + [1] * 20 + [-1] * 5, [0] * 30 + [1] * 10], np.int32)
    pos = np.zeros_like(seg)
    for r in range(2):
        for s in np.unique(seg[r]):
            idx = np.where(seg[r] == s)[0]
            pos[r, idx] = 0 if s < 0 else np.arange(len(idx))
    ids = rng.integers(2, vocab, seg.shape).astype(np.int32)
    labels = np.where((seg >= 0) & (pos > 0), ids, -100).astype(np.int32)
    return {"input_ids": ids, "positions": pos, "segment_ids": seg, "labels": labels}


def _port_loss_and_grads(cfg, flat, batch, seed):
    dec = load_flat(Decoder(cfg), flat)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits, _ = dec(t["input_ids"], positions=t["positions"], segment_ids=t["segment_ids"],
                    dropout_seed=seed)
    loss = cross_entropy_loss(logits, t["labels"])
    loss.backward()
    return loss.item(), grads_to_flat(dec), dec


def _jax_masks(key, jcfg):
    """The keys JAX's `forward` splits from `key`, by the port's site names,
    and the keys of the layers layerdrop should skip."""
    k_embed, k_layers = jax.random.split(key)
    layer_keys = jax.random.split(k_layers, jcfg.num_layers * 4).reshape(jcfg.num_layers, 4, 2)
    keys = {(transformer.EMBED,): k_embed}
    for i in range(jcfg.num_layers):
        for site, j in ((transformer.ATTN_PROBS, 1), (transformer.ATTN_RES, 2),
                        (transformer.MLP_RES, 3)):
            keys[(site, i)] = layer_keys[i, j]
    return keys, [layer_keys[i, 0] for i in DROPPED]


@pytest.mark.parametrize("layout,knobs", [
    ("pre_norm", dict(dropout=0.2, layerdrop=0.5)),
    ("parallel_residual", dict(dropout=0.2, layerdrop=0.5)),
    ("post_ln", dict(dropout=0.2, layerdrop=0.5)),
    ("pre_norm", dict(dropout=0.2, attention_dropout=0.3, layerdrop=0.5, attn_impl="xla")),
    ("post_ln", dict(attention_dropout=0.3, attn_impl="xla")),
])
def test_same_masks_give_jax_loss_and_gradients(layout, knobs, monkeypatch):
    cfg, jcfg = _configs(layout, **knobs)
    flat = _random_flat(jcfg)
    batch = _batch(cfg.vocab_size)
    key = jax.random.PRNGKey(7)
    keys, dropped_keys = _jax_masks(key, jcfg)
    real_bernoulli = jax.random.bernoulli
    drawn = []

    def keep_mask(seed, site, shape, rate, device):
        drawn.append(site)
        return torch.from_numpy(np.array(real_bernoulli(keys[site], 1.0 - rate,
                                                        tuple(shape))))

    def jax_bernoulli(k, p=0.5, shape=None):
        if shape is not None:
            return real_bernoulli(k, p, shape)
        hit = jnp.zeros((), bool)   # layerdrop's keep decision
        for dk in dropped_keys:
            hit = hit | jnp.all(k == dk)
        return ~hit

    monkeypatch.setattr(jax.random, "bernoulli", jax_bernoulli)
    monkeypatch.setattr(transformer, "_keep_mask", keep_mask)
    monkeypatch.setattr(transformer, "_layer_drops",
                        lambda seed, n, rate: [i in DROPPED for i in range(n)])

    def jax_loss(params):
        logits, _ = jax_transformer.forward(
            params, jcfg, jnp.asarray(batch["input_ids"]),
            positions=jnp.asarray(batch["positions"]),
            segment_ids=jnp.asarray(batch["segment_ids"]), dropout_rng=key)
        return jax_cross_entropy(logits, jnp.asarray(batch["labels"]))

    want_loss, want_grads = jax.value_and_grad(jax_loss)(
        jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)))
    want = _flatten(want_grads)
    loss, got, _ = _port_loss_and_grads(cfg, flat, batch, seed=3)
    np.testing.assert_allclose(loss, float(want_loss), **TOL)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], np.asarray(want[k]), **TOL, err_msg=k)
    # every live site was drawn, and none of the skipped layers'
    live = [i for i in range(cfg.num_layers) if cfg.layerdrop == 0 or i not in DROPPED]
    want_sites = ({(transformer.EMBED,)} if cfg.dropout else set()) | {
        (s, i) for i in live for s, rate in ((transformer.ATTN_PROBS, cfg.attention_dropout),
                                             (transformer.ATTN_RES, cfg.dropout),
                                             (transformer.MLP_RES, cfg.dropout)) if rate}
    assert set(drawn) == want_sites
    if cfg.layerdrop:   # the skipped layers' gradients are zeros, as JAX's
        for k, g in got.items():
            if k.startswith("layers/"):
                assert not np.any(g[list(DROPPED)]), k
    # without the seed the forward is deterministic: the JAX forward without a key
    loss0, _, _ = _port_loss_and_grads(cfg, flat, batch, seed=None)
    logits0, _ = jax_transformer.forward(
        jax.tree_util.tree_map(jnp.asarray, _unflatten(flat)), jcfg,
        jnp.asarray(batch["input_ids"]), positions=jnp.asarray(batch["positions"]),
        segment_ids=jnp.asarray(batch["segment_ids"]))
    np.testing.assert_allclose(
        loss0, float(jax_cross_entropy(logits0, jnp.asarray(batch["labels"]))), **TOL)


@pytest.mark.parametrize("remat", [dict(), dict(remat=True), dict(remat=True, remat_policy="qkv")])
def test_rate_zero_is_the_deterministic_forward(remat):
    """Rates named at 0 with a seed, and rates above 0 without one, give the
    deterministic forward's loss and gradients bit for bit."""
    cfg, jcfg = _configs("pre_norm", **remat)
    flat = _random_flat(jcfg)
    batch = _batch(cfg.vocab_size)
    loss, grads, _ = _port_loss_and_grads(cfg, flat, batch, seed=None)
    for knobs, seed in ((dict(dropout=0.0, attention_dropout=0.0, layerdrop=0.0), 5),
                        (dict(dropout=0.3, layerdrop=0.5), None),
                        (dict(attention_dropout=0.3, attn_impl="xla"), None)):
        l2, g2, _ = _port_loss_and_grads(dataclasses.replace(cfg, **knobs), flat, batch, seed)
        assert l2 == loss, knobs
        for k in grads:
            np.testing.assert_array_equal(g2[k], grads[k], err_msg=f"{knobs} {k}")


def test_masks_kept_share_seeds_and_sites():
    n_rows, n_cols, rate = 1000, 1024, 0.1
    keep = transformer._keep_mask(5, (transformer.ATTN_RES, 2), (n_rows, n_cols), rate, "cpu")
    n = keep.numel()
    sigma = np.sqrt(n * rate * (1 - rate))
    assert n >= 1_000_000 and abs(int(keep.sum()) - n * (1 - rate)) <= 5 * sigma
    again = transformer._keep_mask(5, (transformer.ATTN_RES, 2), (n_rows, n_cols), rate, "cpu")
    assert torch.equal(keep, again)
    for seed, site in ((6, (transformer.ATTN_RES, 2)), (5, (transformer.ATTN_RES, 3)),
                       (5, (transformer.MLP_RES, 2))):
        other = transformer._keep_mask(seed, site, (n_rows, n_cols), rate, "cpu")
        assert not torch.equal(keep, other), (seed, site)
        # independent streams: the masks agree where two coins would
        agree = float((keep == other).float().mean())
        assert abs(agree - (rate ** 2 + (1 - rate) ** 2)) < 0.01
    # layerdrop: a host draw per forward, the skipped share near the rate
    drops = np.array([transformer._layer_drops(s, 24, 0.1) for s in range(2000)])
    assert drops.shape == (2000, 24)
    assert abs(drops.mean() - 0.1) <= 5 * np.sqrt(0.1 * 0.9 / drops.size)
    assert transformer._layer_drops(3, 24, 0.1) == transformer._layer_drops(3, 24, 0.1)
    # no draw touches the global generator
    state = torch.random.get_rng_state()
    transformer._keep_mask(1, (transformer.EMBED,), (4, 4), 0.5, "cpu")
    transformer._layer_drops(1, 4, 0.5)
    assert torch.equal(state, torch.random.get_rng_state())


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_scaling_is_jax_dropout_bit_for_bit(dtype, monkeypatch):
    """where(keep, x / (1 - p), 0) in the compute dtype; in bf16 a multiply by
    1 / (1 - p) would round some values the other way."""
    key = jax.random.PRNGKey(3)
    x = jax.random.normal(jax.random.PRNGKey(4), (64, 96), jnp.float32).astype(dtype)
    rate = 0.1
    want = jax_transformer._dropout(x, rate, key)
    mask = np.array(jax.random.bernoulli(key, 1.0 - rate, x.shape))
    monkeypatch.setattr(transformer, "_keep_mask", lambda *a: torch.from_numpy(mask))
    tx = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = transformer._dropout(tx, rate, 0, (transformer.EMBED,))
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert transformer._dropout(tx, rate, None, (transformer.EMBED,)) is tx
    assert transformer._dropout(tx, 0.0, 1, (transformer.EMBED,)) is tx


@pytest.mark.parametrize("attn", [dict(), dict(attention_dropout=0.2, attn_impl="xla")])
def test_remat_policies_agree_and_qkv_runs_attention_once(attn, monkeypatch):
    """Real masks, layer 1 skipped: the gradients under no remat, "full",
    "qkv" and partial remat (2 of 4 layers) are bitwise equal; the flash path
    runs `flash_attention` once a layer that runs under "qkv" and twice under
    "full"; the skipped layer's gradients are zeros, not absent."""
    calls = []
    real = transformer.flash_attention
    monkeypatch.setattr(transformer, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    monkeypatch.setattr(transformer, "_layer_drops",
                        lambda seed, n, rate: [i == 1 for i in range(n)])
    cfg, jcfg = _configs("pre_norm", dropout=0.1, layerdrop=0.3, **attn)
    flat = _random_flat(jcfg)
    batch = _batch(cfg.vocab_size)
    runs = {}
    for name, knobs in (("none", dict()), ("full", dict(remat=True)),
                        ("qkv", dict(remat=True, remat_policy="qkv")),
                        ("qkv_partial", dict(remat=True, remat_policy="qkv", remat_layers=2)),
                        ("full_partial", dict(remat=True, remat_layers=2))):
        calls.clear()
        loss, grads, dec = _port_loss_and_grads(dataclasses.replace(cfg, **knobs), flat,
                                                batch, seed=9)
        runs[name] = (loss, grads, len(calls))
        assert all(p.grad is not None for p in dec.parameters())
        assert all(not p.grad.any() for p in dec.layers[1].parameters())
    base_loss, base, _ = runs["none"]
    for name, (loss, grads, _) in runs.items():
        assert loss == base_loss, name
        for k in base:
            np.testing.assert_array_equal(grads[k], base[k], err_msg=f"{name} {k}")
    if not attn:   # 3 layers run: flash once each, twice under full remat
        assert {k: v[2] for k, v in runs.items()} == {
            "none": 3, "full": 6, "qkv": 3, "qkv_partial": 3, "full_partial": 4}
    else:          # probability dropout: the plain attention, never flash
        assert all(v[2] == 0 for v in runs.values())


def test_flash_path_refuses_attention_dropout():
    """As JAX (`tests/test_transformer.py:258`): attention_dropout > 0 with a
    seed on the flash path raises; without a seed it runs; "auto" on the CPU
    is the plain attention, which takes it."""
    cfg, jcfg = _configs("pre_norm", attention_dropout=0.1, attn_impl="flash")
    flat = _random_flat(jcfg)
    ids = torch.zeros((1, 8), dtype=torch.long)
    dec = load_flat(Decoder(cfg), flat)
    with pytest.raises(ValueError, match="attention_dropout"):
        dec(ids, dropout_seed=0)
    with pytest.raises(ValueError, match="attention_dropout"):
        jax_transformer.forward(jax_init_params(jcfg, jax.random.PRNGKey(0)), jcfg,
                                jnp.zeros((1, 8), jnp.int32), dropout_rng=jax.random.PRNGKey(0))
    dec(ids)
    auto = load_flat(Decoder(dataclasses.replace(cfg, attn_impl="auto")), flat)
    assert torch.isfinite(auto(ids, dropout_seed=0)[0]).all()


# --------------------------------------------------------------------------- #
# the trainers
# --------------------------------------------------------------------------- #
TINY = dict(base_model_name="EleutherAI/pythia-14m", vocab_size=64, twist_init=False,
            torch_dtype="float32", dropout=0.2, layerdrop=0.3)


def _train_args(out, **overrides):
    from slamkit_tpu_torch.config import compose

    ov = [f"training_args.output_dir={out}", "training_args.per_device_train_batch_size=8",
          "training_args.max_steps=4", "training_args.logging_steps=1",
          "training_args.eval_strategy=no", "training_args.save_steps=0",
          "training_args.gradient_accumulation_steps=2",
          "data.train_path=/dev/null", "data.val_path=/dev/null"]
    ov += [f"training_args.{k}={v}" for k, v in overrides.items()]
    return compose("config", "train", ov).training_args.to_container()


def _dataset(n=128, seed=0):
    rng = np.random.default_rng(seed)
    return TokenDataset.from_lists([rng.integers(2, 64, size=rng.integers(5, 30)).tolist()
                                    for _ in range(n)])


class _StopAt(TrainerCallback):
    def __init__(self, step):
        self.step = step

    def on_step_end(self, args, state, control, **kw):
        if state.global_step >= self.step:
            control.should_training_stop = True
            control.should_save = True


def test_trainer_stream_rides_in_the_checkpoint_and_resumes_exactly(tmp_path):
    """Counterpart of `tests/test_trainer.py::test_train_with_dropout`: the
    straight 4-step run, and 2 steps + a resume, end on the same weights bit
    for bit; the checkpoint holds the stream; the dropout is live (another
    seed, other weights); eval draws no mask."""
    ds, evals = _dataset(), _dataset(16, seed=1)

    def run(out, resume=False, stop_at=None, **over):
        model = UnitLM(UnitLMConfig(**TINY), seed=0, device="cpu")
        tr = SLAMTrainer(model, _train_args(out, **over), ds, eval_dataset=evals,
                         callbacks=[_StopAt(stop_at)] if stop_at else [], context_len=32)
        tr.train(resume_from_checkpoint=resume)
        return {k: p.detach().clone() for k, p in model.decoder.named_parameters()}, tr

    straight, tr = run(tmp_path / "a")
    assert tr.dropout_stream is not None
    losses = [r["loss"] for r in tr.state.log_history if "loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    run(tmp_path / "b", stop_at=2)
    saved = torch.load(tmp_path / "b" / "checkpoint-2" / "state" / "train_state.pt",
                       weights_only=True)
    assert saved["dropout_rng"].dtype == torch.uint8 and saved["kind"] == "adamw"
    resumed, tr_resumed = run(tmp_path / "b", resume=True)
    assert torch.equal(tr.dropout_stream.get_state(), tr_resumed.dropout_stream.get_state())
    for k in straight:
        assert torch.equal(resumed[k], straight[k]), k
    other, _ = run(tmp_path / "c", seed=1)
    assert any(not torch.equal(other[k], straight[k]) for k in straight)
    # evaluation: deterministic, the dropout-free model's on the same weights
    first = tr.evaluate()["eval_loss"]
    assert tr.evaluate()["eval_loss"] == first
    plain = UnitLM(UnitLMConfig(**{**TINY, "dropout": 0.0, "layerdrop": 0.0}), seed=0,
                   device="cpu")
    plain.decoder.load_state_dict(tr.model.decoder.state_dict())
    tr.model = plain
    assert tr.evaluate()["eval_loss"] == first


def _pref_rows(n, seed):
    rng = np.random.default_rng(seed)
    unit = lambda ids: "".join(f"<Un{i}>" for i in ids)
    return [{"prompt": unit(rng.integers(0, 60, 5)), "chosen": unit([7, 8, 9]),
             "rejected": unit(rng.integers(20, 60, 4))} for _ in range(n)]


def test_dpo_dropout_is_live_seeded_and_resumes(tmp_path):
    """Counterpart of `tests/test_dpo.py::test_dpo_dropout_active_and_seeded`:
    two same-seed runs agree bit for bit and differ from a dropout-0 run
    after step 1 (step 1 is ln 2 only without dropout); a run stopped at step
    2 and resumed ends on the straight run's weights and losses."""
    from slamkit_tpu_torch.config import compose
    from slamkit_tpu_torch.tokeniser import UnitTokeniser

    tok = UnitTokeniser(num_units=60)
    rows = _pref_rows(16, 0)

    def run(dropout, out, resume=False, stop_at=None):
        model = UnitLM(UnitLMConfig(base_model_name="EleutherAI/pythia-14m",
                                    vocab_size=62 + tok.offset, twist_init=False,
                                    torch_dtype="float32", dropout=dropout,
                                    attention_dropout=dropout, layerdrop=dropout,
                                    attn_implementation="xla"), seed=0, device="cpu")
        args = compose("config", "preference_alignment_train", [
            "data.train_path=/dev/null", "data.val_path=/dev/null",
            f"training_args.output_dir={tmp_path / out}",
            "training_args.per_device_train_batch_size=1", "training_args.max_steps=3",
            "training_args.logging_steps=1"]).training_args
        tr = SLAMDPOTrainer(model, tok, args, rows,
                            callbacks=[_StopAt(stop_at)] if stop_at else [])
        state = tr.train(resume_from_checkpoint=resume)
        return ([r["loss"] for r in state.log_history if "loss" in r],
                {k: p.detach().clone() for k, p in model.decoder.named_parameters()})

    base, _ = run(0.0, "d0")
    drop_a, w_a = run(0.3, "da")
    drop_b, _ = run(0.3, "db")
    assert drop_a == drop_b
    assert any(a != b for a, b in zip(base[1:], drop_a[1:]))
    assert base[0] == pytest.approx(np.log(2), abs=1e-6)
    run(0.3, "dc", stop_at=2)
    resumed, w_c = run(0.3, "dc", resume=True)
    assert resumed[-1] == drop_a[-1]
    for k in w_a:
        assert torch.equal(w_c[k], w_a[k]), k


def test_cli_train_at_the_slice_overrides_resumes_exactly(tmp_path):
    """`cli.train model=slam` (2 layers, 64 wide) with dropout 0.1, layerdrop
    0.1, remat qkv and Adafactor, 2 steps with a save each, and a run resumed
    from checkpoint-1: its step-2 loss and exported weights equal the
    uninterrupted run's bit for bit; `model=twist` with the plain attention
    and attention_dropout 0.1 takes 2 finite steps."""
    from slamkit_tpu_torch.cli import train as cli_train
    from slamkit_tpu_torch.tools.slam_recipe import write_markov_corpus

    tokens = tmp_path / "tokens.jsonl"
    write_markov_corpus(tokens, 32, (20, 60))
    common = [f"data.train_path={tokens}", f"data.val_path={tokens}", "data.packing=true",
              "model.context_len=64", "model.config_args.torch_dtype=float32",
              "+model.config_args.num_hidden_layers=2", "+model.config_args.hidden_size=64",
              "+model.config_args.intermediate_size=128", "training_args.max_steps=2",
              "training_args.save_steps=1", "training_args.per_device_train_batch_size=2",
              "training_args.gradient_accumulation_steps=2", "training_args.logging_steps=1",
              "training_args.use_cpu=true"]
    slice_ = ["model=slam", "model.config_args.dropout=0.1", "model.config_args.layerdrop=0.1",
              "model.config_args.remat=true", "model.config_args.remat_policy=qkv",
              "training_args.optim=adafactor"]
    first = cli_train.train([*slice_, *common, f"training_args.output_dir={tmp_path / 'a'}"])
    again = cli_train.train([*slice_, *common, f"training_args.output_dir={tmp_path / 'b'}",
                             f"cont_training={tmp_path / 'a' / 'checkpoint-1'}"])
    loss = lambda st: [r["loss"] for r in st.log_history if "loss" in r][-1]
    assert first.global_step == again.global_step == 2 and loss(first) == loss(again)
    cfg = json.loads((tmp_path / "a" / "checkpoint-2" / "unit_lm_config.json").read_text())
    assert (cfg["dropout"], cfg["layerdrop"], cfg["remat_policy"]) == (0.1, 0.1, "qkv")
    with np.load(tmp_path / "a" / "checkpoint-2" / "params.npz") as x, \
            np.load(tmp_path / "b" / "checkpoint-2" / "params.npz") as y:
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    twist = cli_train.train([
        "model.config_args.attn_implementation=xla", "model.config_args.attention_dropout=0.1",
        *[c for c in common if "num_hidden_layers" not in c and "hidden_size" not in c
          and "intermediate_size" not in c],
        "+model.config_args.num_hidden_layers=2", f"training_args.output_dir={tmp_path / 't'}"])
    assert twist.global_step == 2
    assert all(np.isfinite(r["loss"]) for r in twist.log_history if "loss" in r)


def test_chip_smoke_training_settings_rehearsal_on_cpu(tmp_path, capsys):
    """Phase 15 end to end on the CPU at a 2-layer width and context 64:
    (a) resumes bit for bit, (b) the remat policies' gradients are bitwise
    equal, (c) the masks' statistics hold, (d) the plain attention trains and
    resumes and the flash path refuses, (e) DPO's dropout runs repeat and
    differ from the rates at 0, (f) Adafactor holds; no launch is counted
    and every checkpoint is dropped."""
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    narrow = lambda kv: ["model.context_len=64"] + [
        f"+model.config_args.{k}={v}" for k, v in dict(
            num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
            num_key_value_heads=kv, head_dim=16, intermediate_size=128).items()]
    result = chip_smoke.run_training_settings(
        torch.device("cpu"), "cpu rehearsal", tmp_path, slam_overrides=narrow(2),
        twist_overrides=narrow(4), n_rows=24, lengths=(10, 40), batch=2, accum=2,
        timed_steps=1, mask_shape=(1000, 1024), n_pref=4, dpo_batch=2, prompt_len=10,
        completion_len=5, adafactor_scale=4)
    assert result["launches"] == {"flash_fwd": 0, "flash_bwd": 0}
    assert result["slam"]["layers"] == 2 and len(result["slam"]["kept_layers"]) == 4
    assert result["remat"]["kept_layers"] == 1
    assert result["adafactor"]["max_rel_err"] == 0.0 and result["adafactor"]["factored"] == 5
    assert result["dpo"]["no_dropout"]["losses"][0] == pytest.approx(np.log(2), abs=1e-6)
    json.dumps(result)
    out = capsys.readouterr().out
    assert "slam resumed: step 2" in out and "checkpoint-2 weights bitwise equal: True" in out
    assert "twist on the flash path with attention_dropout=0.1 raises" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        ["settings_tokens.jsonl", "settings_val.jsonl", "settings_pref.jsonl"])
